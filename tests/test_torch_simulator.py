"""The paper's runtime model — memory manager, discrete-event scheduler,
overlap engine, d2d fabric, recovery engine — in the port against the
reference, on the CPU.

Every scenario of ``tests/_torch_sim.py`` runs the same inputs through both
packages and compares exactly: ``==`` on the makespan, the whole
``SimResult.stats`` dict, busy seconds, chunk tiers, raised errors and
trace JSON.  The claims the reference's own tests make of each scenario
are checked on the port's answer as well.  The recovery engine runs at
chaos seeds 1, 7 and 1234 (marked ``faults``, as the reference's are).
``benchmarks/BENCH_sim.json`` is read, never written: both packages'
runs of its five sections must reproduce it field for field.
"""

import json
from pathlib import Path

import numpy as np
import pytest

import _torch_sim as S
from _torch_parity import plain

REF = S.package("repro")
PORT = S.package("repro_torch")
BENCH = Path(__file__).resolve().parent.parent / "benchmarks" \
    / "BENCH_sim.json"


def port(name, *args):
    return S.run(name, "repro_torch", *args)


def both(name, *args):
    got = port(name, *args)
    assert got == S.run(name, "repro", *args)
    return got


# ---------------------------------------------------------------------------
# Every scenario: identical answers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(S.SCENARIOS))
def test_scenario_matches_reference(name):
    both(name)


@pytest.mark.faults
@pytest.mark.parametrize("seed", S.CHAOS_SEEDS)
@pytest.mark.parametrize("name", sorted(S.SEEDED))
def test_recovery_scenario_matches_reference(name, seed):
    both(name, seed)


# ---------------------------------------------------------------------------
# The reference tests' claims, on the port's answers
# ---------------------------------------------------------------------------


def test_memory_manager_claims():
    r = port("mm_stage_promotes")
    assert r["before"] == "HOST" and r["tiers"][("a", 0)] == "DEVICE"
    assert r["cost"] == pytest.approx(400 / 1e9)
    r = port("mm_lru_eviction")
    assert r["tiers"][("a", 0)] == "HOST"
    assert r["tiers"][("a", 2)] == "DEVICE"
    assert r["stats"]["evictions"] >= 1 and r["stats"]["d2h_bytes"] >= 400
    assert port("mm_pinned_never_evict")["raised"][0] == "OutOfMemory"
    assert port("mm_working_set_too_big")["raised"][0] == "OutOfMemory"
    r = port("mm_spill_cascades")
    assert r["stats"]["host2disk_bytes"] > 0 and r["used"]["DISK"] > 0


@pytest.mark.parametrize("name, evicted, kept, counter", [
    ("mm_oracle_furthest", ("a", 0), [("b", 0), ("c", 0)], None),
    ("mm_no_oracle_lru", ("b", 0), [("a", 0)], None),
    ("mm_peer_replicated_victim", ("a", 1), [("a", 0)], "peer_evictions"),
    ("mm_without_predicate", ("a", 0), [], None),
    ("mm_unknown_key_victim", ("a", 1), [("a", 0), ("a", 2)],
     "oracle_evictions"),
    ("mm_tie_breaks_lru", ("a", 1), [("a", 0)], None),
])
def test_eviction_victims(name, evicted, kept, counter):
    r = port(name)
    assert r["tiers"][evicted] != "DEVICE"
    assert all(r["tiers"][k] == "DEVICE" for k in kept)
    if counter:
        assert r["stats"][counter] == 1
    if name == "mm_without_predicate":
        assert r["stats"]["peer_evictions"] == 0


def test_degradation_claims():
    r = port("mm_degrade_spills")
    assert r["used_before"] == 800 and r["cost"] > 0
    assert r["capacity"] == 750.0 and r["used"] <= 750.0
    assert r["stats"]["oom_demotions"] == 1
    assert r["tiers"][("a", 0)] == "HOST"
    r = port("mm_degrade_floors")
    assert [s is not None for s in r["steps"]] == [True, True, True, False]
    assert r["capacity"] == 500.0
    assert port("mm_degrade_keeps_pinned")["tiers"][("a", 0)] == "DEVICE"
    r = port("genuine_oom")
    assert r["raised"][0] == "OutOfMemory"


def test_simulator_scaling_and_chunk_size_claims():
    r = port("sim_completes")
    lp, _ = S.stencil_plan(PORT)
    assert r["makespan"] > 0 and r["task_count"] == len(lp.plan.tasks)
    r = port("sim_more_devices")
    assert r[4]["makespan"] < r[1]["makespan"] / 2.5
    tiny, mid, huge = (port(f"chunk_{k}")["makespan"]
                       for k in ("tiny", "mid", "huge"))
    assert mid <= tiny and mid <= huge * 1.5


def test_staging_throttle_claims():
    tight = port("throttle_stage_wait")
    ample = port("throttle_ample")
    assert tight["result"]["stats"]["stage_wait"] > 0
    assert tight["throttled_since"] == {}
    assert ample["stats"]["stage_wait"] == 0
    assert tight["result"]["makespan"] > ample["makespan"]
    death = port("throttle_worker_death")
    assert death["result"]["task_count"] == 4
    assert death["result"]["stats"]["worker_deaths"] == 1
    assert death["throttled_since"] == {}


def test_utilization_claims():
    r = port("utilization_normalized")
    assert r["two"] == pytest.approx(0.75) and r["zero"] == 0.0
    r = port("utilization_four_workers")
    assert r["result"]["num_workers"] == 4
    assert 0.0 < r["compute"] <= 1.0


@pytest.mark.parametrize("chunk", [1 << 13, 1 << 17, 1 << 21])
def test_prefetch_improves_overlap_never_makespan(chunk):
    r = port(f"prefetch_sweep_{chunk}")
    assert r["prefetch"]["makespan"] <= r["base"]["makespan"]
    assert r["overlap_prefetch"]["overlap_fraction"] \
        > r["overlap_base"]["overlap_fraction"]


def test_prefetch_and_eviction_claims():
    r = port("prefetch_off_by_default")
    assert r["default"] == r["off"]
    s = port("prefetch_counters")["stats"]
    assert s["prefetch_issued"] > 0 and s["prefetch_bytes"] > 0
    assert s["prefetch_hits"] + s["prefetch_wasted"] <= s["prefetch_issued"]
    s = port("prefetch_keys_present")["stats"]
    for k in ("prefetch_issued", "prefetch_bytes", "prefetch_hits",
              "prefetch_wasted"):
        assert s[k] == 0
    assert port("bad_eviction_policy")["raised"][0] == "ValueError"
    r = port("belady_vs_lru")
    lru, bel = r["lru"]["stats"], r["belady"]["stats"]
    assert lru["evictions"] > 0
    assert bel["h2d_bytes"] < lru["h2d_bytes"]
    assert bel["evictions"] < lru["evictions"]
    assert r["belady"]["makespan"] <= r["lru"]["makespan"]
    assert bel["oracle_evictions"] > 0 and lru["oracle_evictions"] == 0


def test_fabric_claims():
    r = port("interconnect_model")
    assert r["nodes"] == [0, 0, 1, 1] and r["same"] == [True, False]
    assert r["times"][0] < r["times"][1]
    assert r["cheapest"] == [2, 0, 1]
    r = port("paper_presets")
    assert r["cluster_is_p100"]
    r = port("d2d_host_vs_fabric")
    host, fab = r["host"], r["fabric"]
    assert fab["stats"]["h2d_bytes"] < host["stats"]["h2d_bytes"]
    assert fab["makespan"] <= host["makespan"]
    assert fab["stats"]["d2d_bytes"] > 0
    assert fab["stats"]["multicast_fanout"] > 0
    for k in ("d2d_bytes", "d2d_transfers", "multicast_fanout",
              "d2d_in_bytes"):
        assert host["stats"][k] == 0
    off = port("d2d_multicast_off")
    assert off["stats"]["multicast_fanout"] == 0
    assert off["stats"]["d2d_transfers"] >= 1
    assert off["stats"]["h2d_bytes"] < host["stats"]["h2d_bytes"]
    r = port("no_topology_traces")
    assert r["default"] == r["no_multicast"]
    assert r["pf"] == r["pf_no_multicast"]
    assert '"d2d"' not in r["default"]


def test_fabric_trace_claims():
    r = port("d2d_trace")
    p2p = [e for e in json.loads(r["trace"])["traceEvents"]
           if e["name"].split(":")[0] in ("d2d", "multicast")]
    assert p2p and all(e["cat"] == "transfer" for e in p2p)
    streams = set()
    for d in r["overlap"]["devices"]:
        streams |= set(d["transfer_streams_s"])
        assert sum(d["transfer_streams_s"].values()) >= \
            d["busy_s"]["transfer"] - 1e-12
    assert {"d2d", "h2d"} <= streams
    r = port("prefetch_rides_d2d")
    pf = [e for e in json.loads(r["trace"])["traceEvents"]
          if e["name"].startswith("prefetch:") and "src" in e["args"]]
    assert pf and r["result"]["stats"]["d2d_transfers"] >= len(pf)
    assert port("prefetch_skip_and_continue")["stats"]["prefetch_skipped"] > 0
    s = port("prefetch_nothing_blocked")["stats"]
    assert s["prefetch_skipped"] == 0 and s["prefetch_issued"] > 0
    s = port("peer_evictions_under_pressure")["stats"]
    assert s["evictions"] > 0 and s["peer_evictions"] > 0
    r = port("belady_death_with_d2d")
    assert r["stats"]["worker_deaths"] == 1
    assert r["task_count"] == len(S.shared_input_plan(PORT).tasks)


def test_dead_worker_never_sources_d2d():
    r = port("dead_worker_never_sources")
    assert r["result"]["stats"]["worker_deaths"] == 1
    events = json.loads(r["trace"])["traceEvents"]
    death = [e["ts"] for e in events if e["name"] == "worker_death"]
    assert death
    for e in events:
        if e["ph"] == "X" and e["ts"] >= death[0] and "src" in e["args"]:
            assert e["args"]["src"] != 3


@pytest.mark.faults
@pytest.mark.parametrize("seed", S.CHAOS_SEEDS)
def test_recovery_claims(seed):
    lp, _ = S.stencil_plan(PORT)
    r = port("chaos_worker_death", seed)["result"]
    s = r["stats"]
    assert r["task_count"] == len(lp.plan.tasks)
    assert np.isfinite(r["makespan"])
    assert s["worker_deaths"] == 1
    assert s["task_retries"] + s["transfer_retries"] >= 3
    assert s["recovered_tasks"] >= 1
    assert s["replica_recoveries"] + s["lineage_replays"] \
        + s["tasks_rescheduled"] >= 1
    r = port("lineage_replay", seed)
    assert r["result"]["stats"]["lineage_replays"] >= 1
    r = port("replay_homes_all_consumers", seed)
    assert ("a", 0) in r["replayed"]
    assert r["homes"][2] and r["homes"][3]
    s = port("spurious_oom", seed)["result"]["stats"]
    assert s["oom_events"] >= 1 and s["recovered_tasks"] >= 1
    for run in port("bounded_schedules", seed):
        s = run["result"]["stats"]
        assert run["result"]["task_count"] == len(lp.plan.tasks)
        assert s["recovered_tasks"] <= s["faults_injected"] \
            + s["tasks_rescheduled"]
    r = port("fault_metrics", seed)
    kinds = {e[0] for e in r["events"]}
    for kind in kinds:
        assert r["snapshot"][f"faults.injected{{kind={kind}}}"] == sum(
            e[0] == kind for e in r["events"])


# ---------------------------------------------------------------------------
# benchmarks/BENCH_sim.json, field for field
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("root", ["repro", "repro_torch"])
@pytest.mark.parametrize("section", sorted(S.BENCH_SECTIONS))
def test_bench_sim_section_reproduces_the_baseline(section, root):
    """The reference's run checks that the driver is ``collect()``'s; the
    port's run checks the port."""
    want = json.loads(BENCH.read_text())[section]
    got = S.BENCH_SECTIONS[section](S.package(root))
    assert json.loads(json.dumps(got)) == want


def test_bench_sim_config_is_the_drivers():
    doc = json.loads(BENCH.read_text())
    assert doc["schema"] == "repro.bench_sim/1"
    assert doc["config"] == {"full": False, "prefetch_window": 8,
                             "chaos_seed": 7}
    assert sorted(doc) == sorted(["schema", "config", *S.BENCH_SECTIONS])


def test_sim_result_and_stat_keys_match():
    for key in ("RECOVERY_STAT_KEYS", "PREFETCH_STAT_KEYS", "D2D_STAT_KEYS",
                "_SIM_STAT_KEYS"):
        assert getattr(PORT.scheduler, key) == getattr(REF.scheduler, key)
    assert PORT.memory.MEM_STAT_KEYS == REF.memory.MEM_STAT_KEYS
    assert [t.name for t in PORT.core.Tier] == [t.name for t in REF.core.Tier]
    assert plain(PORT.scheduler.SimResult(1.0, {}, 0, {})) \
        == plain(REF.scheduler.SimResult(1.0, {}, 0, {}))


@pytest.mark.parametrize("window", [0, 2])
def test_chip_smoke_sim_phase_plans_as_run_one(window, monkeypatch):
    """``chip_smoke.py``'s ``sim`` phase builds its plan as
    ``benchmarks/paper_fig10_chunksize.py:run_one`` does (it copies, not
    imports, that function): on the port's default model both give the
    same prediction."""
    import dataclasses

    monkeypatch.syspath_prepend(str(BENCH.parent.parent))
    import chip_smoke
    from benchmarks.paper_fig10_chunksize import run_one

    n, chunk = 1 << 16, 1 << 12
    got = chip_smoke.simulate_stream(n, chunk, window)
    hw = REF.core.HardwareModel(
        **dataclasses.asdict(PORT.core.HardwareModel()))
    want = run_one(n, chunk, hw=hw, prefetch_window=window)
    assert got["seconds_per_iteration"] == want["makespan_s"]
    assert got["overlap_fraction"] == want["overlap_fraction"]
    assert got["h2d_bytes"] / 1e9 == want["h2d_gb"]
    assert got["stats"]["prefetch_issued"] == want["prefetch_issued"]

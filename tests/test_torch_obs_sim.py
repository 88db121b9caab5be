"""Observability of the simulator and the fault layer in the port against
the reference, on the CPU: the overlap analyzer, the Chrome-trace validator,
the traced simulation's export (byte for byte), the registry-delta stats,
``repro_torch.dist.fault`` (monitors and supervisor), and the hardware
model's constants (the H100's by default, the paper's P100 platform
exactly as the reference has it)."""

import dataclasses
import json

import pytest

import repro.core as R
import repro.dist.fault as Rfault
import repro.obs as Robs
import repro_torch.core as T
import repro_torch.dist as Tdist
import repro_torch.dist.fault as Tfault
import repro_torch.obs as Tobs
from repro_torch.obs import validate as Tvalidate

import _torch_sim as S

REF = S.package("repro")
PORT = S.package("repro_torch")
PACKAGES = {"repro": REF, "repro_torch": PORT}


# ---------------------------------------------------------------------------
# Overlap analyzer
# ---------------------------------------------------------------------------


def synthetic(P):
    tr = P.trace.Tracer()
    tr.complete("k", 0.0, 10.0, worker=0, stream="compute", cat="compute")
    tr.complete("x", 5.0, 10.0, worker=0, stream="h2d", cat="transfer")
    tr.complete("s", 30.0, 2.0, worker=1, stream="sched", cat="sched")
    tr.complete("y", 31.0, 4.0, worker=1, stream="d2d", cat="transfer")
    tr.complete("c", 20.0, 12.0, worker=1, stream="compute", cat="compute")
    tr.instant("f", ts=3.0, worker=0, stream="sched", cat="fault")
    return tr


@pytest.mark.parametrize("form", ["tracer", "chrome", "events"])
def test_analyze_synthetic_trace_matches_reference(form):
    def report(P):
        tr = synthetic(P)
        trace = {"tracer": tr, "chrome": json.loads(tr.to_json()),
                 "events": json.loads(tr.to_json())["traceEvents"]}[form]
        rep = P.overlap.analyze(trace)
        return rep.to_dict(), rep.summary()

    got = report(PORT)
    assert got == report(REF)
    rep = Tobs.analyze(synthetic(PORT))
    assert rep.wall == pytest.approx(35.0)
    d0 = rep.device(0)
    assert d0.overlap == pytest.approx(5.0)
    assert d0.overlap_fraction == pytest.approx(5.0 / 35.0)
    assert d0.exposed_transfer == pytest.approx(5.0)
    assert rep.device(1).transfer_streams == {"d2d": 4.0}
    assert rep.device(7) is None


def test_analyze_empty_trace():
    assert Tobs.analyze(Tobs.Tracer()).to_dict() \
        == Robs.analyze(Robs.Tracer()).to_dict()
    assert Tobs.analyze([]).overlap_fraction == 0.0


def test_multi_worker_plan_report_matches_reference():
    def report(P):
        lp, _ = S.stencil_plan(P)
        tr = P.trace.Tracer()
        P.core.Simulator(S.fault_hw(P), 4, tracer=tr).run(lp.plan)
        rep = P.overlap.analyze(tr)
        return rep.to_dict(), rep.summary(), tr.text_timeline()

    got = report(PORT)
    assert got == report(REF)
    devices = got[0]["devices"]
    assert len(devices) == 4
    for d in devices:
        assert 0.0 <= d["overlap_fraction"] <= 1.0
        assert d["busy_s"]["compute"] > 0.0 and d["busy_s"]["transfer"] > 0.0
    assert "overlap report" in got[1]
    assert "lanes" in got[2].splitlines()[0]


# ---------------------------------------------------------------------------
# Chrome-trace validator
# ---------------------------------------------------------------------------

BROKEN = {
    "not_a_dict": [],
    "no_events_key": {},
    "empty_events": {"traceEvents": []},
    "events_not_list": {"traceEvents": {"a": 1}},
    "event_not_object": {"traceEvents": [3]},
    "missing_keys": {"traceEvents": [{"name": "x", "ph": "X", "ts": 0.0}]},
    "name_not_string": {"traceEvents": [
        {"name": 5, "ph": "i", "ts": 0.0, "pid": 0, "tid": 0}]},
    "ts_not_number": {"traceEvents": [
        {"name": "a", "ph": "i", "ts": "0", "pid": 0, "tid": 0}]},
    "pid_not_int": {"traceEvents": [
        {"name": "a", "ph": "i", "ts": 0.0, "pid": "0", "tid": 0}]},
    "negative_dur": {"traceEvents": [
        {"name": "a", "ph": "X", "ts": 0.0, "dur": -1.0, "pid": 0,
         "tid": 0}]},
    "decreasing_ts": {"traceEvents": [
        {"name": "a", "ph": "i", "ts": 5.0, "pid": 0, "tid": 0},
        {"name": "b", "ph": "i", "ts": 1.0, "pid": 0, "tid": 0}]},
    "metadata_may_sit_at_zero": {"traceEvents": [
        {"name": "a", "ph": "i", "ts": 5.0, "pid": 0, "tid": 0},
        {"name": "process_name", "ph": "M", "ts": 0.0, "pid": 0, "tid": 0},
        {"name": "b", "ph": "i", "ts": 6.0, "pid": 0, "tid": 0}]},
}


@pytest.mark.parametrize("case", sorted(BROKEN))
def test_validator_matches_reference(case):
    got = Tobs.validate_chrome_trace(BROKEN[case])
    assert got == Robs.validate_chrome_trace(BROKEN[case])
    assert (got == []) == (case == "metadata_may_sit_at_zero")


def test_validator_main(tmp_path, capsys):
    good = tmp_path / "good.json"
    tr = Tobs.Tracer()
    tr.complete("k", 0.0, 1e-3, worker=1, stream="compute", cat="compute")
    good.write_text(tr.to_json())
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(BROKEN["decreasing_ts"]))
    junk = tmp_path / "junk.json"
    junk.write_text("{not json")
    assert Tvalidate.main([str(good)]) == 0
    assert Tvalidate.main([str(good), str(bad), str(junk)]) == 1
    assert Tvalidate.main([]) == 2
    out = capsys.readouterr().out
    assert "good.json: ok (3 events)" in out
    assert "bad.json: INVALID" in out and "junk.json: UNREADABLE" in out


# ---------------------------------------------------------------------------
# Traced simulation: the export, byte for byte
# ---------------------------------------------------------------------------


def traced_export(P, **kw):
    lp, _ = S.stencil_plan(P)
    tr = P.trace.Tracer()
    P.core.Simulator(S.fault_hw(P), 4, tracer=tr, **kw).run(lp.plan)
    return tr.to_json()


@pytest.mark.parametrize("kw", [{}, {"prefetch_window": 4},
                                {"eviction": "belady"}],
                         ids=["demand", "prefetch", "belady"])
def test_traced_sim_export_is_the_references_byte_for_byte(kw):
    """No difference is inherent: the exporter names processes
    ``worker<n>`` and threads by stream, never by package."""
    got = traced_export(PORT, **kw)
    assert got == traced_export(REF, **kw)
    assert got == traced_export(PORT, **kw)
    assert Tobs.validate_chrome_trace(json.loads(got)) == []


def test_failed_tasks_counted_and_marked_in_trace():
    def run(P):
        C = P.core
        lp, _ = S.stencil_plan(P)
        reg, tr = P.metrics.MetricsRegistry(), P.trace.Tracer()
        inj = C.FaultInjector([C.fail_task(at=0)], registry=reg)
        res = C.Simulator(S.fault_hw(P), 4, fault_injector=inj,
                          registry=reg, tracer=tr).run(lp.plan)
        return S.result(res), reg.snapshot(), tr.to_json()

    got = run(PORT)
    assert got == run(REF)
    res, snap, trace = got
    assert res["stats"]["task_retries"] == 1
    assert snap["faults.injected{kind=task}"] == 1
    events = json.loads(trace)["traceEvents"]
    assert any(e["name"] == "fault:task_retries" for e in events)


# ---------------------------------------------------------------------------
# Stats on the registry
# ---------------------------------------------------------------------------


def test_sim_stats_ride_the_registry():
    def run(P):
        lp, _ = S.stencil_plan(P)
        reg = P.metrics.MetricsRegistry()
        res = P.core.Simulator(S.fault_hw(P), 4, registry=reg).run(lp.plan)
        return res.stats, reg.snapshot(), len(lp.plan.tasks)

    got = run(PORT)
    assert got == run(REF)
    stats, snap, ntasks = got
    for k in ("stage_wait",) + tuple(PORT.memory.MEM_STAT_KEYS):
        assert k in stats, k
    assert stats["h2d_bytes"] > 0
    assert snap["mem.h2d_bytes"] == stats["h2d_bytes"]
    assert snap["sim.tasks_total"] == ntasks
    per_worker = [v for k, v in snap.items()
                  if k.startswith("mem.h2d_bytes{")]
    assert sum(per_worker) == snap["mem.h2d_bytes"]


@pytest.mark.parametrize("root", sorted(PACKAGES))
def test_sim_stats_are_per_run_deltas_on_the_default_registry(root):
    """Two runs on one shared registry: each ``stats`` is its own run's
    delta.  The shared registry is the process default, swapped for a fresh
    one by ``use_registry`` so no other test's counts leak in."""
    P = PACKAGES[root]
    with P.metrics.use_registry() as reg:
        assert P.metrics.default_registry() is reg
        runs = [P.core.Simulator(S.fault_hw(P), 4,
                                 registry=P.metrics.default_registry())
                .run(S.stencil_plan(P)[0].plan) for _ in range(2)]
        total = reg.snapshot()["mem.h2d_bytes"]
    assert runs[0].stats == runs[1].stats
    assert total == pytest.approx(2 * runs[0].stats["h2d_bytes"])


# ---------------------------------------------------------------------------
# repro_torch.dist.fault
# ---------------------------------------------------------------------------


class CheckpointStub:
    """What the supervisor reads of a checkpoint manager: ``latest_step``."""

    def __init__(self):
        self.step = None

    def latest_step(self):
        return self.step


def straggler_rounds(F):
    mon = F.HeartbeatMonitor(num_hosts=4)
    strag = F.StragglerMonitor(mon, threshold=3.0, patience=2)
    rounds = []
    for _ in range(3):
        for host in range(4):
            mon.beat(host, 1.0 if host != 2 else 10.0)
        rounds.append(strag.evaluate())
    return rounds, [h.quarantined for h in mon.hosts]


def transient_spike(F):
    mon = F.HeartbeatMonitor(num_hosts=3)
    strag = F.StragglerMonitor(mon, threshold=3.0, patience=2, window=1)
    for host in range(3):
        mon.beat(host, 1.0 if host != 1 else 10.0)
    first = (strag.evaluate(), mon.hosts[1].straggler_flags)
    for host in range(3):
        mon.beat(host, 1.0)
    return first, strag.evaluate(), mon.hosts[1].straggler_flags, \
        mon.hosts[1].quarantined


def single_host(F):
    mon = F.HeartbeatMonitor(num_hosts=1)
    strag = F.StragglerMonitor(mon, threshold=1.1, patience=1)
    mon.beat(0, 42.0)
    return strag.evaluate()


def backup_assignment(F):
    t = [0.0]
    mon = F.HeartbeatMonitor(num_hosts=4, timeout=5.0, clock=lambda: t[0])
    strag = F.StragglerMonitor(mon)
    for host in range(4):
        mon.beat(host, 1.0)
    mon.hosts[1].quarantined = True
    t[0] = 10.0
    for host in (0, 3):
        mon.beat(host, 1.0)
    return (mon.dead_hosts(), mon.healthy_hosts(),
            strag.backup_assignment(data_shards=8),
            mon.hosts[0].recent_step_time(),
            [list(h.step_times) for h in mon.hosts])


def no_healthy_host(F):
    mon = F.HeartbeatMonitor(num_hosts=2)
    for h in mon.hosts:
        h.quarantined = True
    with pytest.raises(RuntimeError) as exc:
        F.StragglerMonitor(mon).backup_assignment(data_shards=4)
    return str(exc.value)


def supervisor_resume(F):
    ckpt = CheckpointStub()
    starts = []

    def step_fn(start):
        starts.append(start)
        if len(starts) == 1:
            ckpt.step = 5
            raise RuntimeError("simulated worker loss")
        return 12

    sup = F.TrainSupervisor(ckpt, max_restarts=2, clock=lambda: 1.5)
    return sup.run(step_fn, total_steps=12), starts, \
        [dataclasses.astuple(e) for e in sup.events]


def supervisor_backoff(F):
    slept = []
    sup = F.TrainSupervisor(CheckpointStub(), max_restarts=3, backoff=0.5,
                            sleep=slept.append, clock=lambda: 0.0)

    def always_fail(start):
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError):
        sup.run(always_fail, total_steps=1)
    return slept, [dataclasses.astuple(e) for e in sup.events]


def supervisor_no_checkpoint(F):
    starts = []

    def step_fn(start):
        starts.append(start)
        if len(starts) == 1:
            raise RuntimeError("early loss, nothing saved yet")
        return 3

    sup = F.TrainSupervisor(CheckpointStub(), max_restarts=1,
                            clock=lambda: 0.0)
    none = F.TrainSupervisor(None, clock=lambda: 0.0)
    return sup.run(step_fn, total_steps=3), starts, \
        none.run(lambda s: s + 7, total_steps=7)


def supervisor_jitter(F, seed):
    slept = []
    sup = F.TrainSupervisor(CheckpointStub(), max_restarts=4, backoff=0.5,
                            max_backoff=30.0, sleep=slept.append,
                            clock=lambda: 0.0, jitter_seed=seed)

    def always_fail(start):
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError):
        sup.run(always_fail, total_steps=1)
    return slept


FAULT_CASES = {
    "straggler_rounds": straggler_rounds,
    "transient_spike": transient_spike,
    "single_host": single_host,
    "backup_assignment": backup_assignment,
    "no_healthy_host": no_healthy_host,
    "supervisor_resume": supervisor_resume,
    "supervisor_backoff": supervisor_backoff,
    "supervisor_no_checkpoint": supervisor_no_checkpoint,
    "supervisor_jitter_7": lambda F: supervisor_jitter(F, 7),
    "supervisor_jitter_8": lambda F: supervisor_jitter(F, 8),
}


@pytest.mark.parametrize("case", sorted(FAULT_CASES))
def test_fault_layer_matches_reference(case):
    with Tobs.use_registry() as treg, Robs.use_registry() as rreg:
        got = FAULT_CASES[case](Tfault)
        want = FAULT_CASES[case](Rfault)
        assert treg.snapshot() == rreg.snapshot()
    assert got == want


def test_fault_layer_claims():
    rounds, quarantined = straggler_rounds(Tfault)
    assert rounds == [[], [2], []] and quarantined == [False, False, True,
                                                       False]
    first, second, flags, quarantined = transient_spike(Tfault)
    assert first == ([], 1) and second == [] and flags == 0
    assert not quarantined
    assert single_host(Tfault) == []
    dead, healthy, backup, _, _ = backup_assignment(Tfault)
    assert dead == [1, 2] and healthy == [0, 3] and sorted(backup) == [0, 3]
    assert sorted(s for v in backup.values() for s in v) == list(range(8))
    last, starts, events = supervisor_resume(Tfault)
    assert last == 12 and starts == [0, 5]
    assert [e[0] for e in events] == ["failure", "resume", "complete"]
    assert events[1][1] == 5
    slept, _ = supervisor_backoff(Tfault)
    assert slept == [0.5, 1.0, 2.0]
    assert supervisor_no_checkpoint(Tfault)[:2] == (3, [0, 0])
    a, b = supervisor_jitter(Tfault, 7), supervisor_jitter(Tfault, 8)
    assert a == supervisor_jitter(Tfault, 7) and a != b
    assert all(0.5 <= d <= 30.0 for d in a)


def test_dist_exports_the_fault_layer():
    for name in ("FaultEvent", "HeartbeatMonitor", "HostState",
                 "StragglerMonitor", "TrainSupervisor"):
        assert getattr(Tdist, name) is getattr(Tfault, name)
        assert name in Tdist.__all__
    assert Tfault.HostState(3).recent_step_time() is None


# ---------------------------------------------------------------------------
# The hardware model's constants
# ---------------------------------------------------------------------------

#: NVIDIA H100 SXM5 80GB at 700 W, from its data sheet: FP32 on the CUDA
#: cores, HBM3, PCIe Gen5 x16 one way, NVLink 4 one way
H100 = {"flops": 67e12, "hbm_bw": 3.35e12, "device_capacity": 80e9,
        "host_link_bw": 64e9, "ici_bw": 450e9}


def test_default_hardware_model_is_the_h100():
    hw = T.HardwareModel()
    for name, value in H100.items():
        assert getattr(hw, name) == value, name
    assert hw.topology is None
    # every other field is the paper's host, disk, network and scheduler
    # cost, as the reference has it
    ref = R.HardwareModel()
    for f in dataclasses.fields(hw):
        if f.name not in H100:
            assert getattr(hw, f.name) == getattr(ref, f.name), f.name


@pytest.mark.parametrize("preset", ["paper_p100", "paper_cluster"])
def test_paper_presets_equal_the_references(preset):
    got = dataclasses.asdict(getattr(T.HardwareModel, preset)())
    assert got == dataclasses.asdict(getattr(R.HardwareModel, preset)())
    assert dataclasses.asdict(T.Interconnect.paper_cluster()) \
        == dataclasses.asdict(R.Interconnect.paper_cluster())
    assert dataclasses.asdict(T.Interconnect()) \
        == dataclasses.asdict(R.Interconnect())


def test_a_reference_model_carries_over_with_its_interconnect():
    ref = dataclasses.replace(R.HardwareModel.paper_cluster(),
                              device_capacity=3e6)
    hw = S.carried(PORT, ref)
    assert isinstance(hw.topology, T.Interconnect)
    assert dataclasses.asdict(hw) == dataclasses.asdict(ref)

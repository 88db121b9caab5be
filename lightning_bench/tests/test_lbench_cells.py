"""Whole runs of the cells on the CPU at tiny sizes, with the kernels'
plain versions under the program's launch path: sound runs come out
correct, runs with a fault planted under the timed path and the control
come out not correct, and the ranks traffic runs over 2 gloo ranks."""

import pytest
import torch

import bench_faults
from lbench_cells import ROOT, SIZES, TWO_RANKS, run
from lightning_bench.harness import bench, session
from lightning_bench.reference import hotspot as hs_ref
from lightning_bench.reference import kmeans as km_ref


@pytest.mark.parametrize("workload", ["kmeans.resident", "hotspot.resident"])
@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(workload, trace):
    out = run(workload, trace=trace)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    if trace:
        assert {"plan_ms", "plan_cache_hit_share"} <= set(out["metrics"])
        assert "busy_s" in out["device"] and "window_s" in out["device"]
    else:
        assert {"app_ms", "app_ms_p95", "setup_s"} <= set(out["metrics"])


@pytest.mark.parametrize("workload", ["kmeans.resident", "hotspot.resident"])
def test_two_gloo_ranks(workload):
    out = run(workload, mix=TWO_RANKS, seconds=0.5)
    assert out["correct"], out["checks"]
    assert out["device"]["count"] == 2
    assert out["checks"]["patterns_off"]["value"] == 0


def test_traced_ranks_count_halo_bytes():
    from repro_torch.dist import ranks

    spec = session.Spec(ROOT, "hotspot.resident", 7, 0.5, True,
                        SIZES["hotspot"], TWO_RANKS)
    rs = ranks.spawn(session.rank_main, 2, device="cpu", args=(spec,),
                     timeout=120)
    # one row of 96 f32 each way a launch, on either rank
    for r in rs:
        assert bench.metric("halo_bytes_per_launch").read(r) == 2 * 96 * 4


def test_traffic_files_of_the_open_cells_load():
    assert bench.traffic("ranks4")["placement"] == "ranks"
    assert bench.traffic("streamed")["placement"] == "host"


def test_host_placement_streams_kmeans():
    out = run("kmeans.resident", mix={"placement": "host",
                                      "chunk_rows": 5000})
    assert out["correct"], out["checks"]
    assert "patterns_off" not in out["checks"]


FAULTS = [
    ("kmeans.resident", None, bench_faults.kmeans_state_unchanged),
    ("kmeans.resident", None, bench_faults.kmeans_half_batch),
    ("kmeans.resident", None, bench_faults.kmeans_answer_altered),
    ("kmeans.resident", TWO_RANKS, bench_faults.kmeans_exchange_left_out),
    ("hotspot.resident", None, bench_faults.hotspot_state_unchanged),
    ("hotspot.resident", None, bench_faults.hotspot_half_batch),
    ("hotspot.resident", None, bench_faults.hotspot_answer_altered),
    ("hotspot.resident", None, bench_faults.hotspot_power_dropped),
    ("hotspot.resident", None, bench_faults.hotspot_ambient_dropped),
    ("hotspot.resident", TWO_RANKS, bench_faults.hotspot_exchange_left_out),
]


@pytest.mark.parametrize("workload,mix,fault", FAULTS,
                         ids=[f.__name__ for _, _, f in FAULTS])
def test_fault_under_the_timed_path_is_not_correct(workload, mix, fault):
    out = run(workload, mix=mix, fault=fault)
    assert not out["correct"], out["checks"]
    assert out["failed"] >= 1


@pytest.mark.parametrize("workload,traffic", [
    ("kmeans.resident", "resident"), ("hotspot.resident", "resident"),
    ("hotspot.resident", "ranks4")])
def test_control_fails_a_limit(workload, traffic):
    cell = bench.cell(ROOT, workload)
    params = {**cell.config, **SIZES[workload.split(".")[0]]}
    mix = bench.traffic(traffic)
    gaps = cell.app.control(params, mix, 5, "cpu", mix.get("ranks", 1))
    assert any(v > cell.reference.LIMITS[k] for k, v in gaps.items()), gaps


def test_any_run_of_rows_is_drawn_alike():
    temp, power = hs_ref.draw_rows(3, 0, 3000, 40, "cpu")
    t2, p2 = hs_ref.draw_rows(3, 1000, 2100, 40, "cpu")
    assert torch.equal(temp[1000:2100], t2)
    assert torch.equal(power[1000:2100], p2)
    centre, _ = km_ref.centres(3, 40, 4)
    pts = km_ref.draw_points(3, 0, (1 << 20) + 50, centre, "cpu")
    part = km_ref.draw_points(3, (1 << 20) - 7, (1 << 20) + 50, centre, "cpu")
    assert torch.equal(pts[-57:], part)
    assert (pts - centre.new_zeros(1)).abs().max() <= 6.5


def test_reference_rows_of_a_slab_match_the_whole():
    c = bench.cell(ROOT, "hotspot.resident").config["constants"]
    whole = hs_ref.final_rows(9, 0, 80, 80, 24, 20, c, torch.float64, "cpu")
    part = hs_ref.final_rows(9, 30, 50, 80, 24, 20, c, torch.float64, "cpu")
    assert torch.equal(whole[30:50], part)

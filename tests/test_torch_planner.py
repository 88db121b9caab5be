"""Planner, annotation and tracer parity: reference (``repro``) against the
port (``repro_torch``).  Plans are pure Python, so parity is exact: any
difference is a copy error."""

import pytest

import repro.core as R
import repro.obs as Robs
import repro_torch.core as T
import repro_torch.obs as Tobs
from repro_torch.convert import dist_from_reference, work_from_reference

from _torch_parity import launch_plan_rows, plain, task_rows

ANNOTATIONS = {
    "stencil": "global i => read inp[i-1:i+1], write out[i]",
    "quickstart": "global i => read input[i-1:i+1], write output[i]",
    "gemm": "global [i, j] => read A[i,:], read B[:,j], write C[i,j]",
    "colsum": "global [i, j] => read A[i,j], reduce(+) s[j]",
    "hotspot": "global [i, j] => read temp[i-1:i+1, j-1:j+1], "
               "read power[i,j], write out[i,j]",
    "kmeans": "global i => read points[i,:], read centroids[:,:], "
              "reduce(+) sums[:,:], reduce(+) counts[:]",
    "cluster_sums": "global [i, j] => read z[i,j], read row_assign[i], "
                    "read col_assign[j], reduce(+) cc[:,:]",
    "block_local": "block b, local t => read x[4*b + t], write y[4*b + t]",
    "minmax": "global i => read x[i], reduce(min) lo[0], reduce(max) hi[0]",
}


@pytest.mark.parametrize("name", sorted(ANNOTATIONS))
def test_annotation_ast_equal(name):
    try:
        want = R.parse(ANNOTATIONS[name])
    except R.AnnotationError as exc:
        with pytest.raises(T.AnnotationError) as got:
            T.parse(ANNOTATIONS[name])
        assert str(got.value) == str(exc)
        return
    assert plain(T.parse(ANNOTATIONS[name])) == plain(want)


@pytest.mark.parametrize("text", [
    "global i => read A[i*i]", "global i read A[i]", "global i => frob A[i]",
    "global i => reduce(^) s[i]",
])
def test_annotation_errors_equal(text):
    with pytest.raises(R.AnnotationError) as want:
        R.parse(text)
    with pytest.raises(T.AnnotationError) as got:
        T.parse(text)
    assert str(got.value) == str(want.value)


def _launches():
    """(name, annotation, grid, work, {array: (shape, dtype_size, dist)},
    devices, devices_per_node), with reference-side objects; the port's are
    made through ``repro_torch.convert``."""
    D = R
    yield ("stencil_halo", "stencil", (1024,), D.EvenWork(),
           {"inp": ((1024,), 4, D.StencilDist(128, 1)),
            "out": ((1024,), 4, D.BlockDist(128))}, 8, 4)
    yield ("gemm_gather", "gemm", (512, 512), D.EvenWork(),
           {"A": ((512, 512), 4, D.RowDist()),
            "B": ((512, 512), 4, D.RowDist()),
            "C": ((512, 512), 4, D.RowDist())}, 8, 4)
    yield ("colsum_reduce", "colsum", (512, 16), D.EvenWork(),
           {"A": ((512, 16), 4, D.RowDist()),
            "s": ((16,), 4, D.ReplicatedDist())}, 8, 4)
    yield ("gemm_replicated_b", "gemm", (512, 512), D.EvenWork(),
           {"A": ((512, 512), 4, D.RowDist()),
            "B": ((512, 512), 4, D.ReplicatedDist()),
            "C": ((512, 512), 4, D.RowDist())}, 8, 4)
    yield ("gemm_coldist_a", "gemm", (512, 512), D.EvenWork(),
           {"A": ((512, 512), 4, D.ColDist()),
            "B": ((512, 512), 4, D.RowDist()),
            "C": ((512, 512), 4, D.RowDist())}, 8, 4)
    yield ("quickstart_one_device", "quickstart", (4096,), D.BlockWork(512),
           {"input": ((4096,), 4, D.StencilDist(512, 1)),
            "output": ((4096,), 4, D.StencilDist(512, 1))}, 1, 4)
    yield ("hotspot_one_device", "hotspot", (256, 384), D.BlockWork(32),
           {"temp": ((256, 384), 4, D.StencilDist(32, 1)),
            "power": ((256, 384), 4, D.BlockDist(32)),
            "out": ((256, 384), 4, D.StencilDist(32, 1))}, 1, 4)
    yield ("hotspot_four_devices", "hotspot", (256, 384), D.EvenWork(),
           {"temp": ((256, 384), 4, D.StencilDist(64, 1)),
            "power": ((256, 384), 4, D.BlockDist(64)),
            "out": ((256, 384), 4, D.BlockDist(64))}, 4, 2)
    yield ("kmeans_one_device", "kmeans", (4096,), D.BlockWork(512),
           {"points": ((4096, 4), 4, D.RowDist(8)),
            "centroids": ((40, 4), 4, D.ReplicatedDist()),
            "sums": ((40, 4), 4, D.ReplicatedDist()),
            "counts": ((40,), 4, D.ReplicatedDist())}, 1, 4)
    yield ("kmeans_eight_devices", "kmeans", (4096,), D.EvenWork(),
           {"points": ((4096, 4), 4, D.RowDist()),
            "centroids": ((40, 4), 4, D.ReplicatedDist()),
            "sums": ((40, 4), 4, D.ReplicatedDist()),
            "counts": ((40,), 4, D.ReplicatedDist())}, 8, 4)
    yield ("gemm_tiles", "gemm", (256, 256), D.TileWork((128, 128)),
           {"A": ((256, 256), 2, D.TileDist((128, 128))),
            "B": ((256, 256), 2, D.TileDist((128, 128))),
            "C": ((256, 256), 2, D.TileDist((128, 128)))}, 4, 4)
    yield ("cluster_sums_one_device", "cluster_sums", (128, 96),
           D.EvenWork(),
           {"z": ((128, 96), 4, D.RowDist(8)),
            "row_assign": ((128,), 4, D.RowDist(8)),
            "col_assign": ((96,), 4, D.ReplicatedDist()),
            "cc": ((4, 3), 4, D.ReplicatedDist())}, 1, 4)


LAUNCHES = {row[0]: row[1:] for row in _launches()}


def _both_sides(case, **planner_kw):
    ann, grid, work, arrays, devices, per_node = LAUNCHES[case]
    ref_planner = R.Planner(R.Topology(devices, devices_per_node=per_node),
                            registry=Robs.MetricsRegistry(), **planner_kw)
    port_planner = T.Planner(T.Topology(devices, devices_per_node=per_node),
                             registry=Tobs.MetricsRegistry(), **planner_kw)
    ref_arrays = {n: R.ArrayMeta(n, s, b, d) for n, (s, b, d) in arrays.items()}
    port_arrays = {n: T.ArrayMeta(n, s, b, dist_from_reference(d))
                   for n, (s, b, d) in arrays.items()}
    ref_args = (case, R.parse(ANNOTATIONS[ann]), grid, work, ref_arrays)
    port_args = (case, T.parse(ANNOTATIONS[ann]), grid,
                 work_from_reference(work), port_arrays)
    return ref_planner, ref_args, port_planner, port_args


@pytest.mark.parametrize("case", sorted(LAUNCHES))
def test_plans_equal_task_by_task(case):
    ref_planner, ref_args, port_planner, port_args = _both_sides(case)
    want = ref_planner.plan_launch(*ref_args)
    got = port_planner.plan_launch(*port_args)
    assert launch_plan_rows(got) == launch_plan_rows(want)
    assert got.plan.counts() == want.plan.counts()
    assert got.plan.comm_bytes() == want.plan.comm_bytes()
    assert got.total_comm_bytes() == want.total_comm_bytes()
    got.plan.validate()


@pytest.mark.parametrize("case", sorted(LAUNCHES))
def test_cached_replay_equals_native_planning(case):
    """Three launches into one shared plan: the port's cached replay equals
    its own uncached planning and the reference's, cross-launch dependency
    edges included, and hits the cache as often as the reference."""
    ref_c, ref_args, port_c, port_args = _both_sides(case, cache_plans=True)
    _, _, port_n, _ = _both_sides(case, cache_plans=False)
    plans = {}
    for key, planner, args, mod in (("ref", ref_c, ref_args, R),
                                    ("cached", port_c, port_args, T),
                                    ("native", port_n, port_args, T)):
        shared = mod.ExecutionPlan(launch_name="pipeline")
        for _ in range(3):
            planner.plan_launch(*args, plan=shared)
        shared.validate()
        plans[key] = task_rows(shared)
    assert plans["cached"] == plans["native"]
    assert plans["cached"] == plans["ref"]
    assert port_c._registry.snapshot() == ref_c._registry.snapshot()


def test_locality_placement_equal():
    case = "gemm_coldist_a"
    ref_p, ref_args, port_p, port_args = _both_sides(case,
                                                     placement="locality")
    assert (launch_plan_rows(port_p.plan_launch(*port_args))
            == launch_plan_rows(ref_p.plan_launch(*ref_args)))


def _drive_tracer(mod):
    ticks = iter(range(1000))
    tracer = mod.Tracer(clock=lambda: float(next(ticks)))
    with tracer.span("plan:stencil", stream="host", cat="sched",
                     grid=[1024]):
        tracer.instant("cache_miss", stream="host", cat="sched",
                       args={"n": 1})
    with tracer.span("launch:stencil", stream="host", cat="compute",
                     devices=1) as sp:
        sp.add(attempt=1)
        with tracer.span("copy", worker=1, stream="h2d", cat="transfer"):
            pass
    tracer.complete("exec", ts=10.0, dur=2.5, worker=2, stream="compute",
                    cat="compute", args={"sb": 3})
    return tracer


def test_chrome_trace_json_byte_identical():
    want, got = _drive_tracer(Robs), _drive_tracer(Tobs)
    assert got.to_json() == want.to_json()
    assert got.text_timeline() == want.text_timeline()
    assert Tobs.CHROME_REQUIRED_KEYS == Robs.CHROME_REQUIRED_KEYS


def test_metrics_registry_snapshot_equal():
    snaps = []
    for mod in (Robs, Tobs):
        reg = mod.MetricsRegistry()
        reg.counter("launch.count").labels(kernel="k").inc()
        reg.counter("launch.count").labels(kernel="k").inc(2)
        reg.gauge("depth").set(3)
        h = reg.histogram("t", buckets=(0.1, 1.0))
        for v in (0.05, 0.5, 5.0):
            h.observe(v)
        snaps.append(reg.snapshot())
    assert snaps[0] == snaps[1]

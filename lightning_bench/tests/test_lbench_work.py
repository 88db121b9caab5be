"""The work counts that rooflines are taken from, held to hand counts at
two shapes each."""

import json
import os

import pytest

from lightning_bench.configs import hotspot, kmeans
from lightning_bench.reference import hotspot as hs_ref
from lightning_bench.harness.peaks import H100_SXM, least_seconds

RESIDENT = {"placement": "resident"}
WEAK4 = {"placement": "ranks", "ranks": 4, "scale": "weak"}


@pytest.mark.parametrize("n,k,f,ops,nbytes", [
    # n k (2f + 3) + 2 n f; 4 (n f + 2 k f + k)
    (1000, 40, 4, 1000 * 40 * 11 + 8000, 4 * (4000 + 320 + 40)),
    (2 ** 29, 40, 4, 240_518_168_576, 8_589_936_032),
])
def test_kmeans_counts(n, k, f, ops, nbytes):
    params = {"n_points": n, "clusters": k, "features": f, "iterations": 5}
    w = kmeans.work(params, RESIDENT, 1)
    assert w["kernels"]["kmeans"]["ops"] == ops
    assert w["kernels"]["kmeans"]["bytes"] == nbytes
    assert w["app"] == (5 * ops, 5 * nbytes)
    # weak scaling: each card holds the configuration's whole size
    assert kmeans.work(params, WEAK4, 4)["kernels"]["kmeans"]["ops"] == ops


@pytest.mark.parametrize("rows,cols,ops,nbytes", [
    (10, 7, 14 * 70, 12 * 70),
    (32768, 32768, 15_032_385_536, 12_884_901_888),
])
def test_hotspot_counts(rows, cols, ops, nbytes):
    params = {"rows": rows, "cols": cols, "steps": 20}
    w = hotspot.work(params, RESIDENT, 1)
    assert w["kernels"]["hotspot"]["ops"] == ops
    assert w["kernels"]["hotspot"]["bytes"] == nbytes
    assert w["app"] == (20 * ops, 20 * nbytes)
    assert hotspot.work(params, WEAK4, 4)["kernels"]["hotspot"] == \
        w["kernels"]["hotspot"]


def test_least_times_at_the_cells_sizes():
    # K-Means by its operations (3.59 ms), HotSpot by its bytes (3.85 ms)
    km = kmeans.work({"n_points": 2 ** 29, "clusters": 40, "features": 4,
                      "iterations": 5}, RESIDENT, 1)["kernels"]["kmeans"]
    hs = hotspot.work({"rows": 32768, "cols": 32768, "steps": 20},
                      RESIDENT, 1)["kernels"]["hotspot"]
    assert least_seconds(km["ops"], km["bytes"], H100_SXM) == \
        km["ops"] / 67e12
    assert least_seconds(hs["ops"], hs["bytes"], H100_SXM) == \
        hs["bytes"] / 3.35e12


def test_hotspot_constants_are_rodinias_and_stable():
    cfg = json.load(open(os.path.join(os.path.dirname(hotspot.__file__),
                                      "hotspot.json")))
    c = cfg["constants"]
    want = hs_ref.rodinia_constants(cfg["rodinia"], cfg["rows"], cfg["cols"])
    assert c == pytest.approx(want, rel=1e-12)
    # step / Cap = 1e-6 / (MAX_PD * cell area): 1.398 at 32768^2
    assert c["sdc"] == pytest.approx(1e-6 / (3e6 * (0.016 / 32768) ** 2))
    # the checkerboard mode's factor a step lies inside (-1, 1)
    assert abs(1 - c["sdc"] * (4 * c["rx"] + 4 * c["ry"] + c["rz"])) < 1

"""The slice as a whole: the paper's pipelines through ``Context.launch``
on both sides (reference on JAX/CPU with Pallas interpret mode, port on CPU
tensors), from the same numpy inputs.  Elementwise pipelines compare at
rtol 1e-5; pipelines through a kernel compare at that kernel's tolerance."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
import repro.kernels as RK
import repro_torch.core as T
import repro_torch.kernels as TK
from repro.kernels.coclustering.ref import coclustering_iteration_ref as r_cc_iter
from repro_torch.convert import array_from_reference
from repro_torch.kernels.coclustering.ref import coclustering_iteration_ref as t_cc_iter

KMEANS_ANN = ("global i => read points[i,:], read centroids[:,:], "
              "reduce(+) sums[:,:], reduce(+) counts[:]")
HOTSPOT_ANN = ("global [i, j] => read temp[i-1:i+1, j-1:j+1], "
               "read power[i,j], write out[i,j]")
CSUMS_ANN = ("global [i, j] => read z[i,j], read row_assign[i], "
             "read col_assign[j], reduce(+) cc[:,:]")
GEMM_ANN = "global [i, j] => read A[i,:], read B[:,j], write C[i,j]"


def _sides():
    """(module, kernels module, Context kwargs, to-array)"""
    return ((R, RK, {}, jnp.asarray),
            (T, TK, {"device": "cpu"}, torch.from_numpy))


def test_kmeans_five_iterations_through_launch():
    rng = np.random.RandomState(0)
    n, k, f = 4096, 8, 4
    centers = (rng.rand(k, f) * 10).astype(np.float32)
    pts = (centers[rng.randint(0, k, n)]
           + rng.randn(n, f).astype(np.float32) * 0.3).astype(np.float32)
    cen0 = pts[rng.choice(n, k, replace=False)].copy()

    def inertia(c):
        return ((pts[:, None] - c[None]) ** 2).sum(-1).min(1).sum()

    runs = []
    for mod, kern, kw, _ in _sides():
        def body(v, info, kern=kern):
            sums, counts = kern.kmeans_assign_reduce(
                v["points"], v["centroids"], block=1024)
            return {"sums": sums, "counts": counts}

        ctx = mod.Context(**kw)
        kdef = mod.KernelDef.define("kmeans", body, KMEANS_ANN)
        points = ctx.array(pts, dist=mod.RowDist(8), name="points")
        sums = ctx.zeros((k, f), name="sums")
        counts = ctx.zeros((k,), name="counts")
        cen, prev, trail = cen0, inertia(cen0), []
        for _ in range(5):
            res = ctx.launch(kdef, grid=(n,), work_dist=mod.BlockWork(512),
                             args={"points": points,
                                   "centroids": ctx.array(cen, name="centroids"),
                                   "sums": sums, "counts": counts})
            cnt = res["counts"].to_numpy()
            assert cnt.sum() == n
            cen = res["sums"].to_numpy() / np.maximum(cnt, 1)[:, None]
            cur = inertia(cen)
            assert cur <= prev * 1.001
            prev = cur
            trail.append(cen)
        assert {a: p.value for a, p in ctx.records[-1].comm.items()} == {
            "points": "local", "centroids": "replicated", "sums": "reduce",
            "counts": "reduce"}
        runs.append(trail)
    for want, got in zip(*runs):
        # the K-Means kernel's tolerance for sums, carried to the means
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def test_hotspot_200_steps_relax_to_ambient_through_launch():
    finals = []
    for mod, kern, kw, _ in _sides():
        ctx = mod.Context(**kw)
        kdef = mod.KernelDef.define(
            "hotspot",
            lambda v, info, kern=kern: {
                "out": kern.hotspot_step(v["temp"], v["power"], block_rows=32)},
            HOTSPOT_ANN)
        t = ctx.full((64, 128), 120.0, dist=mod.StencilDist(16, 1),
                     name="temp")
        o = ctx.zeros((64, 128), dist=mod.StencilDist(16, 1), name="out")
        p = ctx.zeros((64, 128), dist=mod.BlockDist(16), name="power")
        for _ in range(200):
            res = ctx.launch(kdef, grid=(64, 128), work_dist=mod.BlockWork(16),
                             args={"temp": t, "power": p, "out": o})
            t, o = res["out"], t
        assert ctx.records[-1].comm["temp"].value == "halo"
        assert len(ctx.records) == 200
        finals.append(t.to_numpy())
    # thermal model relaxes toward ambient (80.0)
    assert abs(float(finals[1].mean()) - 80.0) < 2.0
    # the stencil's own tolerance, after 200 steps of a contracting map
    np.testing.assert_allclose(finals[1], finals[0], rtol=2e-5, atol=2e-4)


def test_hotspot_random_field_through_launch():
    """Two steps only: on a rough field the explicit scheme amplifies its
    high frequencies (and with them any rounding difference) about tenfold
    a step, so a longer run would compare noise."""
    rng = np.random.RandomState(1)
    t_np = (rng.randn(100, 256) * 30 + 60).astype(np.float32)
    p_np = ((rng.randn(100, 256) * 0.5) ** 2).astype(np.float32)
    finals = []
    for mod, kern, kw, _ in _sides():
        ctx = mod.Context(**kw)
        kdef = mod.KernelDef.define(
            "hotspot",
            lambda v, info, kern=kern: {
                "out": kern.hotspot_step(v["temp"], v["power"], block_rows=32)},
            HOTSPOT_ANN)
        t = ctx.array(t_np, dist=mod.StencilDist(25, 1), name="temp")
        o = ctx.zeros((100, 256), dist=mod.StencilDist(25, 1), name="out")
        p = ctx.array(p_np, dist=mod.BlockDist(25), name="power")
        for _ in range(2):
            res = ctx.launch(kdef, grid=(100, 256), work_dist=mod.BlockWork(25),
                             args={"temp": t, "power": p, "out": o})
            t, o = res["out"], t
        finals.append(t.to_numpy())
    np.testing.assert_allclose(finals[1], finals[0], rtol=2e-5, atol=2e-4)


def test_coclustering_objective_not_increasing_through_launch():
    rng = np.random.RandomState(2)
    n, m, nr, nc = 128, 96, 4, 3
    means = rng.rand(nr, nc) * 5 + 0.5
    z = np.abs(means[rng.randint(0, nr, n)][:, rng.randint(0, nc, m)]
               * (1 + 0.05 * rng.randn(n, m))).astype(np.float32)
    ra0 = rng.randint(0, nr, n).astype(np.int32)
    ca0 = rng.randint(0, nc, m).astype(np.int32)

    def objective(cs, ra, ca):
        rc = np.bincount(ra, minlength=nr).astype(np.float64)
        cc = np.bincount(ca, minlength=nc).astype(np.float64)
        avg = cs / (rc[:, None] * cc[None, :] + 1e-8) + 1e-8
        zz = z + 1e-9
        expect = avg[ra][:, ca]
        return float((zz * np.log(zz / expect) - zz + expect).sum())

    runs = []
    for (mod, kern, kw, to_arr), cc_iter in zip(_sides(),
                                                (r_cc_iter, t_cc_iter)):
        ctx = mod.Context(**kw)
        kdef = mod.KernelDef.define(
            "cluster_sums",
            lambda v, info, kern=kern: {"cc": kern.cluster_sums(
                v["z"], v["row_assign"], v["col_assign"], nr, nc)},
            CSUMS_ANN)
        zarr = ctx.array(z, dist=mod.RowDist(8), name="z")
        cc = ctx.zeros((nr, nc), name="cc")

        def sums(ra, ca):
            res = ctx.launch(kdef, grid=(n, m), args={
                "z": zarr, "cc": cc,
                "row_assign": ctx.array(ra, dist=mod.RowDist(8),
                                        name="row_assign"),
                "col_assign": ctx.array(ca, name="col_assign")})
            assert ctx.records[-1].comm["cc"].value == "reduce"
            return res["cc"].to_numpy()

        ra, ca = ra0, ca0
        trail = [sums(ra, ca)]
        prev = objective(trail[-1], ra, ca)
        for _ in range(6):
            ra2, ca2 = cc_iter(to_arr(z), to_arr(ra), to_arr(ca), nr, nc)
            ra, ca = np.asarray(ra2), np.asarray(ca2)
            trail.append(sums(ra, ca))
            cur = objective(trail[-1], ra, ca)
            assert cur <= prev * 1.01, (prev, cur)
            prev = cur
        runs.append((trail, ra, ca))
    np.testing.assert_array_equal(runs[1][1], runs[0][1])
    np.testing.assert_array_equal(runs[1][2], runs[0][2])
    for want, got in zip(runs[0][0], runs[1][0]):
        # cluster_sums' tolerance (order of summation), total mass kept
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(got.sum(), z.sum(), rtol=1e-4)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_gemm_through_launch(dtype, tol):
    rng = np.random.RandomState(3)
    m, k, n = 100, 60, 130
    a_np = rng.randn(m, k).astype(np.float32)
    b_np = rng.randn(k, n).astype(np.float32)
    outs = []
    for mod, kern, kw, to_arr in _sides():
        dt = getattr(jnp if mod is R else torch, dtype)
        cast = (lambda x: x.astype(dt)) if mod is R else (lambda x: x.to(dt))
        ctx = mod.Context(**kw)
        kdef = mod.KernelDef.define(
            "gemm",
            lambda v, info, kern=kern: {"C": kern.gemm(
                v["A"], v["B"], block_m=128, block_n=128, block_k=128)},
            GEMM_ANN)
        res = ctx.launch(kdef, grid=(m, n), args={
            "A": ctx.array(cast(to_arr(a_np)), dist=mod.RowDist(), name="A"),
            "B": ctx.array(cast(to_arr(b_np)), dist=mod.RowDist(), name="B"),
            "C": ctx.zeros((m, n), dtype=dt, dist=mod.RowDist(), name="C")})
        assert {a: p.value for a, p in ctx.records[-1].comm.items()} == {
            "A": "local", "B": "local", "C": "local"}
        c = res["C"].value
        outs.append(np.asarray(c, np.float32) if mod is R
                    else c.to(torch.float32).numpy())
    np.testing.assert_allclose(outs[1], outs[0], rtol=tol, atol=tol)


def test_state_carried_across_through_convert():
    """A reference array and its distribution, handed over as numpy and
    plain values, give the same metadata and chunks in the port."""
    rctx = R.Context()
    x = np.arange(24, dtype=np.float32).reshape(6, 4)
    ra = rctx.array(x, dist=R.StencilDist(2, 1), name="grid")
    tctx = T.Context(device="cpu")
    ta = array_from_reference(tctx, ra.name, np.asarray(ra.value), ra.dist)
    assert ta.name == "grid" and ta.shape == ra.shape
    assert type(ta.dist).__name__ == "StencilDist"
    assert ta.dist.chunk_size == 2 and ta.dist.halo_width == 1
    assert ([(c.index, c.owner, c.region.intervals) for c in ta.chunks(3)]
            == [(c.index, c.owner, c.region.intervals) for c in ra.chunks(3)])
    np.testing.assert_array_equal(ta.to_numpy(), x)
    x[0, 0] = -1.0  # the port keeps its own copy
    assert ta.to_numpy()[0, 0] == 0.0

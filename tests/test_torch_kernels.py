"""The four ported kernels' public functions against the reference's.

The reference ``ops`` run as the reference's own tests run them on a CPU
(Pallas interpret mode); the port runs on CPU tensors, where each wrapper
takes its plain version.  Inputs come from numpy seeds and reach both sides
as numpy.  Tolerances are those of ``tests/test_kernels.py`` for the same
function: they cover another order of summation, nothing more.  The CUDA
kernels themselves are held against the plain versions on the GPU by the
``kernels`` phase of ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels as RK
import repro_torch.kernels as TK
from repro.kernels.coclustering.ref import coclustering_iteration_ref as r_cc_iter
from repro_torch.kernels.coclustering.ref import coclustering_iteration_ref as t_cc_iter
from repro_torch.kernels.common import cdiv, pad_to, round_up
from repro.kernels import common as r_common

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _f32(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _np(x):
    """A jax or torch array as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


# -- GEMM ---------------------------------------------------------------------


@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (256, 384, 128),
                                   (100, 60, 130), (64, 64, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemm_sweep(m, k, n, dtype):
    rng = np.random.RandomState(1000 + m + k + n)
    a, b = _f32(rng, m, k), _f32(rng, k, n)
    want = RK.gemm(jnp.asarray(a).astype(dtype), jnp.asarray(b).astype(dtype),
                   block_m=128, block_n=128, block_k=128)
    got = TK.gemm(torch.from_numpy(a).to(_TORCH_DTYPES[dtype]),
                  torch.from_numpy(b).to(_TORCH_DTYPES[dtype]),
                  block_m=128, block_n=128, block_k=128)
    assert got.dtype == _TORCH_DTYPES[dtype] and got.shape == (m, n)
    # f32: blocked K accumulation reorders sums; bf16: 8 bits of mantissa.
    tol = 1e-4 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_gemm_out_dtype_and_use_ref():
    rng = np.random.RandomState(7)
    a = torch.from_numpy(_f32(rng, 32, 48)).to(torch.bfloat16)
    b = torch.from_numpy(_f32(rng, 48, 16)).to(torch.bfloat16)
    got = TK.gemm(a, b, out_dtype=torch.float32)
    assert got.dtype == torch.float32
    want = RK.gemm(jnp.asarray(_np(a)).astype("bfloat16"),
                   jnp.asarray(_np(b)).astype("bfloat16"),
                   out_dtype=jnp.float32)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)
    assert torch.equal(TK.gemm(a, b, use_ref=True), TK.gemm_ref(a, b))


# -- HotSpot ------------------------------------------------------------------


@pytest.mark.parametrize("shape,block", [((64, 128), 16), ((100, 256), 32),
                                         ((33, 128), 32)])
def test_hotspot_sweep(shape, block):
    rng = np.random.RandomState(2000 + shape[0])
    t = _f32(rng, *shape, scale=30.0) + 60.0
    p = _f32(rng, *shape, scale=0.5) ** 2
    want = RK.hotspot_step(jnp.asarray(t), jnp.asarray(p), block_rows=block)
    got = TK.hotspot_step(torch.from_numpy(t), torch.from_numpy(p),
                          block_rows=block)
    # rounding of the fused expression only
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-4)


def test_hotspot_constants_carry_over():
    rng = np.random.RandomState(5)
    t, p = _f32(rng, 16, 128, scale=5.0) + 70.0, np.abs(_f32(rng, 16, 128))
    consts = dict(sdc=0.1, rx=2.0, ry=3.0, rz=0.5, amb=60.0)
    want = RK.hotspot_step(jnp.asarray(t), jnp.asarray(p), block_rows=16,
                           **consts)
    got = TK.hotspot_step(torch.from_numpy(t), torch.from_numpy(p), **consts)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-4)


# -- K-Means ------------------------------------------------------------------


@pytest.mark.parametrize("n,k,f", [(2048, 40, 4), (1000, 7, 4), (4096, 16, 8)])
def test_kmeans_sweep(n, k, f):
    """The sweep's shapes on the sweep's kind of data (|N(0,1)|).  The two
    frameworks may round ``p·c`` differently, so a point whose two best
    distances agree to ~1e-6 could flip; the seeds below have no such point,
    and the separated-cluster test that follows does not depend on one."""
    rng = np.random.RandomState(3000 + n)
    pts, cen = np.abs(_f32(rng, n, f)), np.abs(_f32(rng, k, f))
    s_want, c_want = RK.kmeans_assign_reduce(jnp.asarray(pts),
                                             jnp.asarray(cen), block=512)
    s_got, c_got = TK.kmeans_assign_reduce(torch.from_numpy(pts),
                                           torch.from_numpy(cen), block=512)
    np.testing.assert_allclose(_np(c_got), _np(c_want), rtol=1e-6)
    np.testing.assert_allclose(_np(s_got), _np(s_want), rtol=1e-4, atol=1e-3)
    assert float(c_got.sum()) == pytest.approx(n)


@pytest.mark.parametrize("n,k,f,spacing,seed", [
    (3000, 12, 4, 5.0, 11), (5001, 9, 2, 4.0, 16), (3000, 5, 8, 4.0, 22),
    (2000, 6, 16, 4.0, 30), (1000, 50, 4, 4.0, 18), (2000, 20, 16, 4.0, 30),
], ids=["plain-f4-k12", "plain-f2-k9", "plain-f8-k5", "plain-f16-k6",
        "plain-f4-k50", "plain-f16-k20"])
def test_kmeans_separated_clusters_counts_exact(n, k, f, spacing, seed):
    """Separated clusters, through the plain version (the tensors lie on the
    CPU): counts exact against the reference and the true labels, sums
    within rtol 1e-4.  ``chip_smoke.py`` holds both routes to the plain
    version at the same shapes on the card: each feature count route
    ``"private"`` is compiled for, and k (f + 1) past what its accumulators
    hold (k = 50 at f = 4, k = 20 at f = 16), which route ``"fma"``
    takes."""
    rng = np.random.RandomState(seed)
    centers = (spacing * np.arange(k)[:, None] + np.zeros((1, f))).astype(
        np.float32)
    which = rng.randint(0, k, n)
    pts = (centers[which] + rng.uniform(-0.5, 0.5, (n, f))).astype(np.float32)
    cen = (centers + rng.uniform(-0.2, 0.2, (k, f))).astype(np.float32)
    s_want, c_want = RK.kmeans_assign_reduce(jnp.asarray(pts),
                                             jnp.asarray(cen), block=512)
    s_got, c_got = TK.kmeans_assign_reduce(torch.from_numpy(pts),
                                           torch.from_numpy(cen))
    np.testing.assert_array_equal(_np(c_got), _np(c_want))
    np.testing.assert_array_equal(_np(c_got), np.bincount(which, minlength=k))
    np.testing.assert_allclose(_np(s_got), _np(s_want), rtol=1e-4, atol=1e-3)


def test_kmeans_exact_ties_go_to_lowest_index():
    """Duplicate centroids: every point ties between them, and both sides
    give it to the lower index."""
    rng = np.random.RandomState(12)
    pts = np.abs(_f32(rng, 500, 4))
    cen = np.abs(_f32(rng, 3, 4))
    cen = np.concatenate([cen, cen[:2]])  # 3 and 4 duplicate 0 and 1
    _, c_want = RK.kmeans_assign_reduce(jnp.asarray(pts), jnp.asarray(cen),
                                        block=128)
    _, c_got = TK.kmeans_assign_reduce(torch.from_numpy(pts),
                                       torch.from_numpy(cen))
    np.testing.assert_array_equal(_np(c_got), _np(c_want))
    assert float(c_got[3]) == 0.0 and float(c_got[4]) == 0.0


def test_kmeans_iteration():
    rng = np.random.RandomState(13)
    pts, cen = np.abs(_f32(rng, 1500, 4)), np.abs(_f32(rng, 6, 4))
    want = RK.kmeans_iteration(jnp.asarray(pts), jnp.asarray(cen), block=500)
    got = TK.kmeans_iteration(torch.from_numpy(pts), torch.from_numpy(cen))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)
    ref = TK.kmeans_iteration(torch.from_numpy(pts), torch.from_numpy(cen),
                              use_ref=True)
    np.testing.assert_allclose(_np(got), _np(ref), rtol=1e-6, atol=1e-6)


# -- co-clustering ------------------------------------------------------------


@pytest.mark.parametrize("n,m,R,C", [(500, 64, 5, 4), (256, 128, 8, 8)])
def test_cluster_sums_sweep(n, m, R, C):
    rng = np.random.RandomState(4000 + n)
    z = np.abs(_f32(rng, n, m))
    ra = rng.randint(0, R, n).astype(np.int32)
    ca = rng.randint(0, C, m).astype(np.int32)
    want = RK.cluster_sums(jnp.asarray(z), jnp.asarray(ra), jnp.asarray(ca),
                           R, C, block_n=128)
    got = TK.cluster_sums(torch.from_numpy(z), torch.from_numpy(ra),
                          torch.from_numpy(ca), R, C, block_n=128)
    # order of summation
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-3)
    # total mass is conserved
    np.testing.assert_allclose(float(got.sum()), float(z.sum()), rtol=1e-4)


def test_coclustering_iteration_same_assignments():
    rng = np.random.RandomState(14)
    n, m, R, C = 128, 96, 4, 3
    means = rng.rand(R, C) * 5 + 0.5
    z = np.abs(means[rng.randint(0, R, n)][:, rng.randint(0, C, m)]
               * (1 + 0.05 * rng.randn(n, m))).astype(np.float32)
    ra = rng.randint(0, R, n).astype(np.int32)
    ca = rng.randint(0, C, m).astype(np.int32)
    want = r_cc_iter(jnp.asarray(z), jnp.asarray(ra), jnp.asarray(ca), R, C)
    got = t_cc_iter(torch.from_numpy(z), torch.from_numpy(ra),
                    torch.from_numpy(ca), R, C)
    # planted blocks are far apart: the argmins cannot flip on rounding
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[0].dtype == torch.int32


# -- shared helpers -----------------------------------------------------------


@pytest.mark.parametrize("axis,multiple", [(0, 8), (1, 128), (-1, 5), (0, 3)])
def test_pad_to_matches_reference(axis, multiple):
    x = np.arange(3 * 7, dtype=np.float32).reshape(3, 7)
    want = r_common.pad_to(jnp.asarray(x), axis % 2, multiple, value=2.0)
    got = pad_to(torch.from_numpy(x), axis, multiple, value=2.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert cdiv(7, 3) == r_common.cdiv(7, 3) == 3
    assert round_up(7, 4) == r_common.round_up(7, 4) == 8

"""Chunk streaming parity on the CPU: ``repro.core.streaming`` against
``repro_torch.core.streaming`` on the same host-resident numpy data.

On the CPU the port streams with a plain loop (there is no copy engine);
the double-buffered path with pinned staging runs only on a GPU and is
driven by the ``stream`` phase of ``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import streaming as r_stream
from repro.kernels.kmeans import kmeans_iteration_ref as r_iteration_ref
from repro_torch.core import streaming as t_stream
from repro_torch.kernels.kmeans import kmeans_iteration_ref as t_iteration_ref


def _sum_both(data, chunk_rows, init, **kw):
    want = r_stream.stream_map_reduce(
        data, kernel=lambda c: c.sum(axis=0), combine=lambda a, b: a + b,
        init=jnp.asarray(init), chunk_rows=chunk_rows, **kw)
    got = t_stream.stream_map_reduce(
        data, kernel=lambda c: c.sum(dim=0), combine=lambda a, b: a + b,
        init=torch.from_numpy(init), chunk_rows=chunk_rows, device="cpu", **kw)
    return got.numpy(), np.asarray(want)


def test_sum_matches_direct_and_reference():
    data = np.random.RandomState(0).rand(10_000, 4).astype(np.float32)
    got, want = _sum_both(data, 1024, np.zeros((4,), np.float32))
    # f32 sums of 10k values in another order
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(got, data.sum(axis=0), rtol=1e-4)


def test_ragged_tail_padding():
    data = np.ones((1000, 2), np.float32)  # 1000 = 3×256 + 232 (ragged)
    got, want = _sum_both(data, 256, np.zeros((2,), np.float32))
    np.testing.assert_allclose(got, [1000.0, 1000.0])
    np.testing.assert_allclose(got, want)


def test_ragged_tail_is_padded_afresh_with_pad_value():
    """Every chunk the kernel sees has ``chunk_rows`` rows, and the tail of
    the last one holds ``pad_value``, not an earlier chunk's rows."""
    data = np.arange(10, dtype=np.float32).reshape(10, 1) + 1.0
    seen = []
    t_stream.stream_map_reduce(
        data, kernel=lambda c: seen.append(c.clone()) or c.sum(),
        combine=lambda a, b: a + b, init=torch.zeros(()), chunk_rows=4,
        pad_value=-1.0, device="cpu")
    assert [tuple(c.shape) for c in seen] == [(4, 1)] * 3
    np.testing.assert_array_equal(seen[-1].numpy().ravel(), [9, 10, -1, -1])
    got, want = _sum_both(data, 4, np.zeros((1,), np.float32), pad_value=-1.0)
    np.testing.assert_allclose(got, want)
    np.testing.assert_allclose(got, [55.0 - 2.0])


def test_no_padding_hands_over_valid_rows_only():
    data = np.ones((10, 3), np.float32)
    rows = []
    got = t_stream.stream_map_reduce(
        data, kernel=lambda c: rows.append(c.shape[0]) or c.sum(dim=0),
        combine=lambda a, b: a + b, init=torch.zeros(3), chunk_rows=4,
        pad_value=None, device="cpu")
    assert rows == [4, 4, 2]
    np.testing.assert_allclose(got.numpy(), [10.0] * 3)


def test_empty():
    got, want = _sum_both(np.zeros((0, 2), np.float32), 16,
                          np.full((2,), 7.0, np.float32))
    np.testing.assert_allclose(got, [7.0, 7.0])
    np.testing.assert_allclose(got, want)


def test_stats_and_iter_chunks():
    data = np.ones((9, 2), np.float32)
    stats = {}
    t_stream.stream_map_reduce(
        data, kernel=lambda c: c.sum(), combine=lambda a, b: a + b,
        init=torch.zeros(()), chunk_rows=4, device="cpu", stats=stats)
    assert stats == {"chunks": 3, "bytes": 72}
    assert [c.shape[0] for c in t_stream.iter_chunks(data, 4)] \
        == [c.shape[0] for c in r_stream.iter_chunks(data, 4)] == [4, 4, 1]


def test_no_gpu_no_quiet_cpu_run():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_stream.stream_map_reduce(
            np.ones((4, 1), np.float32), kernel=lambda c: c.sum(),
            combine=lambda a, b: a + b, init=torch.zeros(()), chunk_rows=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_stream.stream_kmeans(np.ones((4, 2), np.float32), torch.ones(1, 2))


@pytest.mark.parametrize("n,k,chunk_rows,seed,use", [
    (20_000, 8, 4096, 1, False),  # 20000 = 4×4096 + 3616 (ragged tail)
    (6_000, 5, 2048, 2, True),    # 6000 = 2×2048 + 1904 (ragged tail)
    (4_096, 3, 1024, 3, True),    # no ragged tail
])
def test_stream_kmeans_matches_reference(n, k, chunk_rows, seed, use):
    """The reference zero-pads the ragged tail and subtracts the pad count;
    the port hands over the valid rows only.  Both must give the in-memory
    iteration: rtol/atol 2e-4 as in ``tests/test_streaming.py`` (chunk
    partials summed in f32)."""
    rng = np.random.RandomState(seed)
    pts = rng.rand(n, 4).astype(np.float32)
    cen = (pts[rng.choice(n, k, replace=False)] if not use
           else rng.rand(k, 4).astype(np.float32))
    want = r_stream.stream_kmeans(pts, jnp.asarray(cen),
                                  chunk_rows=chunk_rows, use_pallas=use)
    got = t_stream.stream_kmeans(pts, torch.from_numpy(cen),
                                 chunk_rows=chunk_rows, use_kernel=use,
                                 device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    direct = t_iteration_ref(torch.from_numpy(pts), torch.from_numpy(cen))
    np.testing.assert_allclose(got.numpy(), direct.numpy(), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(
        direct.numpy(),
        np.asarray(r_iteration_ref(jnp.asarray(pts), jnp.asarray(cen))),
        rtol=2e-4, atol=2e-4)


def test_stream_kmeans_pad_rows_are_never_counted():
    """A centroid at the origin would attract zero-padded rows: with a
    ragged tail it must still get exactly its own points."""
    rng = np.random.RandomState(4)
    far = (rng.rand(900, 4) + 5.0).astype(np.float32)
    near = (rng.rand(101, 4) * 0.1).astype(np.float32)
    pts = np.concatenate([far, near])
    cen = torch.tensor([[0.0] * 4, [5.5] * 4])
    got = t_stream.stream_kmeans(pts, cen, chunk_rows=256, device="cpu")
    np.testing.assert_allclose(got[0].numpy(), near.mean(axis=0), rtol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), far.mean(axis=0), rtol=1e-5)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_stream_kmeans_takes_the_reference_keyword(use_pallas):
    """A call written against the reference, ``use_pallas=`` by name, runs
    in the port with the same meaning and gives the reference's centroids
    (rtol/atol 2e-4 as above)."""
    rng = np.random.RandomState(5)
    pts = rng.rand(5_000, 4).astype(np.float32)
    cen = rng.rand(6, 4).astype(np.float32)
    want = r_stream.stream_kmeans(pts, jnp.asarray(cen), chunk_rows=1024,
                                  use_pallas=use_pallas)
    got = t_stream.stream_kmeans(pts, torch.from_numpy(cen), chunk_rows=1024,
                                 use_pallas=use_pallas, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    same = t_stream.stream_kmeans(pts, torch.from_numpy(cen), chunk_rows=1024,
                                  use_kernel=use_pallas, device="cpu")
    assert torch.equal(got, same)


def test_stream_kmeans_refuses_two_keywords_that_disagree():
    pts = np.ones((8, 2), np.float32)
    with pytest.raises(ValueError, match="disagree"):
        t_stream.stream_kmeans(pts, torch.ones(1, 2), use_pallas=False,
                               use_kernel=True, device="cpu")
    agreed = t_stream.stream_kmeans(pts, torch.ones(1, 2), use_pallas=False,
                                    use_kernel=False, device="cpu")
    assert torch.equal(agreed, torch.ones(1, 2))

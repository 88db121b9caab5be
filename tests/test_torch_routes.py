"""The multi-route kernels' route functions, on the CPU.

``gemm_route``, ``flash_route``, ``decode_route``, ``correlate_route``,
``wkv6_route``, ``rg_lru_route``, ``kmeans_route``, ``spmv_route`` and
``md5_route`` pick a kernel before
the launch from dtype, shape and alignment alone: ``"wgmma"`` (tensor cores fed by TMA) where TMA can
describe bf16 operands, ``"pipe"`` (f32 on the CUDA cores, its loads a
stage ahead) for f32 GEMM operands of 16-byte rows, ``"mma"``
(``mma.sync`` tensor cores) for bf16 decode attention whose group fits the
kernel, ``"tri"`` (the correlator's tiles with i <= j, the rest mirrored)
for more than one tile of antennas, ``"chunk"`` (WKV6 and RG-LRU as scans
over chunks of time) for T of two chunks or more (three for RG-LRU),
``"private"`` (K-Means with several points a thread and accumulators
private to a thread or a warp) for the feature counts it is compiled for
where its accumulators fit, ``"bin"`` (SpMV's entries binned by column
slice before the gather) for an x past L2 with rows enough to fill the
card, ``"unwind"`` (MD5 with the target's last eight rounds undone) for
every search, and ``"fma"`` (the first kernels) for the rest.
They read only shapes, dtypes and addresses, so CPU tensors stand in for
CUDA ones here; the kernels themselves run on the GPU in
``chip_smoke.py``, which also requires each main-path call to have taken
the route these functions give.
"""

import importlib
import re
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import _build, common

gemm_kernel = importlib.import_module("repro_torch.kernels.gemm.kernel")
flash_kernel = importlib.import_module(
    "repro_torch.kernels.flash_attention.kernel")
decode_kernel = importlib.import_module(
    "repro_torch.kernels.decode_attention.kernel")
corr_kernel = importlib.import_module("repro_torch.kernels.correlator.kernel")
wkv_kernel = importlib.import_module("repro_torch.kernels.rwkv6.kernel")
lru_kernel = importlib.import_module("repro_torch.kernels.rg_lru.kernel")
km_kernel = importlib.import_module("repro_torch.kernels.kmeans.kernel")
spmv_kernel = importlib.import_module("repro_torch.kernels.spmv_ell.kernel")
ROOT = Path(__file__).resolve().parent.parent
spmv_ref = importlib.import_module("repro_torch.kernels.spmv_ell.ref")
md5_kernel = importlib.import_module("repro_torch.kernels.md5.kernel")
nbody_kernel = importlib.import_module("repro_torch.kernels.nbody.kernel")

bf16, f32 = torch.bfloat16, torch.float32


def _mat(rows, cols, dtype, offset=0):
    """A dense (rows, cols) matrix, ``offset`` elements into its buffer."""
    buf = torch.zeros(offset + rows * cols, dtype=dtype)
    return buf[offset:].view(rows, cols)


@pytest.mark.parametrize("m,k,n", [(8192, 8192, 8192), (200, 136, 264),
                                   (1, 8, 8), (128, 64, 256), (300, 1000, 8)])
def test_gemm_bf16_with_aligned_rows_takes_the_tensor_cores(m, k, n):
    a, b = _mat(m, k, bf16), _mat(k, n, bf16)
    assert gemm_kernel.gemm_route(a, b) == "wgmma"


@pytest.mark.parametrize("what,a,b,want", [
    # f32 with whole 16-deep stages and 16-byte rows takes the pipelined
    # route ("pipe"); other f32 keeps the first kernel
    ("f32", _mat(128, 64, f32), _mat(64, 256, f32), "pipe"),
    ("f32 ragged", _mat(100, 60, f32), _mat(60, 130, f32), "fma"),
    ("k not a multiple of 8", _mat(100, 60, bf16), _mat(60, 128, bf16),
     "fma"),
    ("n not a multiple of 8", _mat(128, 64, bf16), _mat(64, 130, bf16),
     "fma"),
    ("chip_smoke's ragged case", _mat(100, 60, bf16), _mat(60, 130, bf16),
     "fma"),
    ("a one element in", _mat(64, 64, bf16, offset=1), _mat(64, 64, bf16),
     "fma"),
    ("b one element in", _mat(64, 64, bf16), _mat(64, 64, bf16, offset=1),
     "fma"),
    ("no k", _mat(64, 0, bf16), _mat(0, 64, bf16), "fma"),
])
def test_gemm_route_sends_what_tma_cannot_describe_to_fma(what, a, b, want):
    assert gemm_kernel.gemm_route(a, b) == want, what


@pytest.mark.parametrize("what,a,b,want", [
    ("8192^3", _mat(8192, 8192, f32), _mat(8192, 8192, f32), "pipe"),
    ("aligned ragged", _mat(200, 144, f32), _mat(144, 260, f32), "pipe"),
    ("k = 16, n = 4", _mat(3, 16, f32), _mat(16, 4, f32), "pipe"),
    ("k = 136: a short last stage", _mat(200, 136, f32),
     _mat(136, 264, f32), "fma"),
    ("n = 130", _mat(100, 64, f32), _mat(64, 130, f32), "fma"),
    ("k = 6", _mat(8, 6, f32), _mat(6, 8, f32), "fma"),
    ("a one element in", _mat(64, 64, f32, offset=1), _mat(64, 64, f32),
     "fma"),
    ("b two elements in", _mat(64, 64, f32), _mat(64, 64, f32, offset=2),
     "fma"),
    ("a four elements in", _mat(64, 64, f32, offset=4), _mat(64, 64, f32),
     "pipe"),
    ("no k", _mat(64, 0, f32), _mat(0, 64, f32), "fma"),
])
def test_gemm_f32_with_whole_stages_takes_the_pipelined_route(what, a, b,
                                                              want):
    assert gemm_kernel.gemm_route(a, b) == want, what


@pytest.mark.parametrize("out_dtype,want", [(None, "pipe"), (f32, "pipe"),
                                            (bf16, "fma")])
def test_gemm_f32_pipelined_route_writes_f32_only(out_dtype, want):
    """Route "pipe" has an f32 result only (its bf16-out instance spilled),
    so an f32 product rounded to bf16 keeps the first kernel."""
    a, b = _mat(256, 64, f32), _mat(64, 128, f32)
    assert gemm_kernel.gemm_route(a, b, out_dtype) == want


def _qkv(d, dtype, s=100, t=100, hq=4, hkv=2, offset=0):
    q = torch.zeros(offset + hq * s * d, dtype=dtype)[offset:]
    k = torch.zeros(hkv * t * d, dtype=dtype)
    return (q.view(1, hq, s, d), k.view(1, hkv, t, d),
            k.clone().view(1, hkv, t, d))


@pytest.mark.parametrize("d", [32, 64, 96, 128, 256, 8, 200])
def test_flash_bf16_takes_the_tensor_cores(d):
    assert flash_kernel.flash_route(*_qkv(d, bf16)) == "wgmma"


@pytest.mark.parametrize("d", [32, 64, 96, 128, 256])
def test_flash_f32_takes_the_cuda_cores(d):
    assert flash_kernel.flash_route(*_qkv(d, f32)) == "fma"


@pytest.mark.parametrize("what,qkv", [
    ("no keys", _qkv(64, bf16, t=0)),
    ("q one element in", _qkv(64, bf16, offset=1)),
])
def test_flash_route_sends_the_rest_to_fma(what, qkv):
    assert flash_kernel.flash_route(*qkv) == "fma", what


def _decode(b, hq, hkv, t, d, dtype, offset=0):
    """q (b, hq, d) ``offset`` elements into its buffer, k and v (b, hkv,
    t, d)."""
    q = torch.zeros(offset + b * hq * d, dtype=dtype)[offset:]
    k = torch.zeros(b * hkv * t * d, dtype=dtype)
    return (q.view(b, hq, d), k.view(b, hkv, t, d),
            k.clone().view(b, hkv, t, d))


@pytest.mark.parametrize("what,shape", [
    ("phi3-mini's decode", (8, 32, 32, 2184, 96)),
    ("gemma-2b's MQA", (8, 8, 1, 2184, 256)),
    ("recurrentgemma-2b's ring buffer", (8, 10, 1, 2048, 256)),
    ("ragged T, group 10", (3, 10, 1, 300, 256)),
    ("group 32 of 128", (2, 32, 1, 100, 128)),
    ("group 64 of 64", (1, 64, 1, 70, 64)),
    ("group 40 padded to 64 rows", (1, 40, 1, 70, 64)),
    ("D = 16", (2, 4, 2, 50, 16)),
])
def test_decode_bf16_takes_the_tensor_cores(what, shape):
    assert decode_kernel.decode_route(*_decode(*shape, bf16)) == "mma", what


@pytest.mark.parametrize("what,args", [
    ("f32", _decode(8, 32, 32, 300, 96, f32)),
    ("f32 MQA", _decode(2, 8, 1, 300, 256, f32)),
    ("D = 40", _decode(2, 4, 2, 64, 40, bf16)),
    ("group 20 of 256: 32 rows x 256 > 4096", _decode(1, 20, 1, 64, 256,
                                                      bf16)),
    ("group 40 of 96: 64 rows x 96 > 4096", _decode(1, 40, 1, 64, 96, bf16)),
    ("group 65", _decode(1, 65, 1, 64, 16, bf16)),
    ("heads not a multiple of kv heads", _decode(1, 6, 4, 64, 64, bf16)),
    ("q one element in", _decode(2, 4, 2, 64, 64, bf16, offset=1)),
])
def test_decode_route_sends_the_rest_to_fma(what, args):
    assert decode_kernel.decode_route(*args) == "fma", what


def _samples(c, t, a, dtype):
    return torch.zeros((c, t, a, 2), dtype=dtype)


@pytest.mark.parametrize("what,shape", [
    ("the paper's size", (1024, 768, 256)),
    ("A = 200: a ragged last tile", (3, 77, 200)),
    ("A = 65: a last tile of one antenna", (2, 33, 65)),
    ("A = 128: two whole tiles", (2, 100, 128)),
    ("one channel, A = 129", (1, 40, 129)),
])
@pytest.mark.parametrize("dtype", [f32, bf16])
def test_correlator_with_more_than_one_tile_takes_the_triangle(what, shape,
                                                               dtype):
    assert corr_kernel.correlate_route(_samples(*shape, dtype)) == "tri", what


@pytest.mark.parametrize("what,samples", [
    ("A = 64: one tile", _samples(2, 513, 64, f32)),
    ("A = 37", _samples(3, 77, 37, f32)),
    ("A = 37, bf16", _samples(3, 77, 37, bf16)),
    ("A = 16", _samples(4, 100, 16, f32)),
    ("A = 1", _samples(2, 10, 1, bf16)),
    ("f16 samples: no kernel takes them", _samples(2, 10, 200, torch.float16)),
])
def test_correlator_route_sends_one_tile_to_fma(what, samples):
    assert corr_kernel.correlate_route(samples) == "fma", what


@pytest.mark.parametrize("a,pairs", [(1, 1), (64, 1), (65, 3), (128, 3),
                                     (129, 6), (200, 10), (256, 10),
                                     (1024, 136)])
def test_correlator_grid_is_the_tiles_on_and_above_the_diagonal(a, pairs):
    """Route "tri" launches n (n + 1) / 2 blocks a channel, n = ceil(A /
    64): at the paper's A = 256, 10 of the 16 tiles."""
    n = -(-a // corr_kernel.TILE)
    assert corr_kernel.tile_pairs(a) == pairs == n * (n + 1) // 2


def _wkv(b, h, t, dk, dv=None, dtype=bf16):
    """r (b, h, t, dk) and v (b, h, t, dv) stand-ins."""
    return (torch.zeros((b, h, t, dk), dtype=dtype),
            torch.zeros((b, h, t, dv or dk), dtype=dtype))


@pytest.mark.parametrize("what,shape,want", [
    ("rwkv6-3b's prefill", (1, 40, 2048, 64), "chunk"),
    ("the engine's shortest prompt, 128", (1, 40, 128, 64), "chunk"),
    ("T = 300, ragged", (1, 4, 300, 64), "chunk"),
    ("T = 161, V = 50", (2, 3, 161, 64, 50), "chunk"),
    ("K = 20", (2, 2, 200, 20, 50), "chunk"),
    ("rwkv6-3b's decode step", (8, 40, 1, 64), "fma"),
    ("T = 127: under two chunks", (1, 40, 127, 64), "fma"),
    ("T = 70", (1, 4, 70, 64), "fma"),
    ("T = 33", (2, 2, 33, 20, 50), "fma"),
])
@pytest.mark.parametrize("dtype", [f32, bf16])
def test_wkv6_takes_the_chunked_scan_from_two_chunks_on(what, shape, want,
                                                        dtype):
    r, v = _wkv(*shape, dtype=dtype)
    assert 2 * wkv_kernel.CHUNK_LEN == 128
    assert wkv_kernel.wkv6_route(r, v) == want, what


@pytest.mark.parametrize("what,t,want", [
    ("recurrentgemma-2b's decode step", 1, "fma"),
    ("T = 2L - 1", 127, "fma"),
    ("T = 2L: the first kernel still faster there", 128, "fma"),
    ("T = 3L - 1", 191, "fma"),
    ("T = 3L", 192, "chunk"),
    ("recurrentgemma-2b's prefill", 2048, "chunk"),
    ("the window check's prompt, 2600", 2600, "chunk"),
])
@pytest.mark.parametrize("dtype", [f32, bf16])
def test_rg_lru_takes_the_chunked_scan_from_three_chunks_on(what, t, want,
                                                            dtype):
    gx = torch.zeros((1, t, 4), dtype=dtype)
    assert lru_kernel.CHUNK_LEN == 64 and lru_kernel.MIN_CHUNKS == 3
    assert lru_kernel.MAX_CHUNKS == 64
    assert lru_kernel.rg_lru_route(gx) == want, what
    # a sweep's chunk length moves the threshold with it
    assert lru_kernel.rg_lru_route(gx, chunk_len=t) == "fma"
    assert lru_kernel.rg_lru_route(gx, chunk_len=max(1, t // 3)) == (
        "chunk" if t >= 3 else "fma")


@pytest.mark.parametrize("t,steps", [
    (192, 64), (2048, 64), (2600, 64), (4096, 64), (4097, 65), (4170, 66),
    (100_000, 1563)])
def test_rg_lru_chunks_grow_past_64_chunks(t, steps):
    """Route "chunk" folds the carry of every chunk before it into each
    chunk's outputs pass, so it splits T into at most 64 chunks: of
    ``CHUNK_LEN`` steps up to T = 4096, longer past it."""
    assert lru_kernel.chunk_steps(t) == steps
    assert -(-t // steps) <= lru_kernel.MAX_CHUNKS
    # a sweep's shorter chunks grow alike
    assert lru_kernel.chunk_steps(t, 16) == max(16, -(-t // 64))


@pytest.mark.parametrize("what,k,f,want", [
    ("the paper's k = 40, f = 4", 40, 4, "private"),
    ("f = 2", 9, 2, "private"),
    ("f = 8", 5, 8, "private"),
    ("f = 16", 6, 16, "private"),
    ("k = 45, f = 4: the most a thread's accumulators hold", 45, 4,
     "private"),
    ("k = 46, f = 4: past them", 46, 4, "fma"),
    ("k = 75, f = 2: the most at f = 2", 75, 2, "private"),
    ("k = 76, f = 2", 76, 2, "fma"),
    ("k = 13, f = 16: the most at f = 16", 13, 16, "private"),
    ("k = 20, f = 16", 20, 16, "fma"),
    ("k = 400, f = 16, chip_smoke's case", 400, 16, "fma"),
    ("f = 3: not compiled for", 7, 3, "fma"),
    ("f = 1", 7, 1, "fma"),
    ("f = 32", 4, 32, "fma"),
])
def test_kmeans_takes_private_accumulators_where_they_fit(what, k, f, want):
    points, centroids = _mat(100, f, f32), _mat(k, f, f32)
    assert km_kernel.kmeans_route(points, centroids) == want, what
    if f in km_kernel.PRIVATE_FEATURES:
        fits = (km_kernel.private_shared_bytes(k, f)
                <= common.H100_MAX_SHARED_BYTES)
        assert fits == (want == "private"), what


@pytest.mark.parametrize("f,offset,want", [
    (4, 0, "private"), (4, 1, "fma"), (4, 2, "fma"), (8, 2, "fma"),
    (16, 0, "private"), (2, 2, "private"), (2, 1, "fma"),
])
def test_kmeans_private_route_needs_aligned_points(f, offset, want):
    """Its vector loads take 16 bytes a point (8 for f = 2)."""
    points = _mat(100, f, f32, offset=offset)
    assert km_kernel.kmeans_route(points, _mat(7, f, f32)) == want


def test_kmeans_private_shared_memory_is_centroids_and_accumulators():
    """k f centroid words, |c|^2 padded to 4 words, then k (f + 1) words a
    thread (256 a block), as the source lays them out; the route's points
    a thread: 64 point floats in registers at most."""
    assert km_kernel.private_shared_bytes(40, 4) == (
        (160 + 40 + 256 * 200) * 4) == 205_600
    assert km_kernel.private_shared_bytes(7, 2) == (
        (14 + 8 + 256 * 21) * 4) == 21_592
    assert [km_kernel.points_per_thread(f)
            for f in (2, 4, 8, 16)] == [16, 16, 8, 4]


def _ell(rows, nnz, n, offset=0):
    """data, cols and x of an ELL matrix, as views of one element each
    (the route reads only shapes and addresses); ``offset`` elements into
    the buffers of data and cols."""
    data = torch.zeros(1 + offset)[offset:].expand(rows, nnz)
    cols = torch.zeros(1 + offset, dtype=torch.int32)[offset:].expand(rows,
                                                                      nnz)
    return data, cols, torch.zeros(1).expand(n)


@pytest.mark.parametrize("what,shape,offset,want", [
    ("the main path's (2^25, 16), n = 2^25", (1 << 25, 16, 1 << 25), 0,
     "bin"),
    ("n = 2^24: x of 64 MiB, past L2", (1 << 25, 16, 1 << 24), 0, "bin"),
    ("n = 2^24 - 1", (1 << 25, 16, (1 << 24) - 1), 0, "fma"),
    ("n = 2^23: x fits L2 beside the stream", (1 << 25, 16, 1 << 23), 0,
     "fma"),
    ("chip_smoke's ragged bin shape", (3 * (1 << 20) + 37, 8, (1 << 24) + 5),
     0, "bin"),
    ("rows = 2^20 - 1: too few count blocks", ((1 << 20) - 1, 16, 1 << 25),
     0, "fma"),
    ("max_nnz 13: no 16-byte loads", (1 << 21, 13, 1 << 25), 0, "fma"),
    ("data 4 bytes off 16", (1 << 21, 16, 1 << 25), 1, "fma"),
    ("2^31 entries", (1 << 27, 16, 1 << 25), 0, "fma"),
    ("max_nnz 8192: past a count block", (1 << 21, 8192, 1 << 25), 0,
     "fma"),
    ("chip_smoke's ragged 300 rows", (300, 16, 300), 0, "fma"),
])
def test_spmv_bins_where_x_is_past_l2(what, shape, offset, want):
    assert spmv_kernel.spmv_route(*_ell(*shape, offset=offset)) == want, what


def test_spmv_bin_layout_is_count_blocks_by_slices():
    """2^22 columns a slice, at most 4096 entries a count block: the main
    path's (2^25, 16) with n = 2^25 is 131,072 count blocks of 256 rows x
    8 slices; a ragged n and rows round up."""
    assert spmv_kernel.bin_layout(1 << 25, 16, 1 << 25) == {
        "slices": 8, "block_row_bits": 8, "count_blocks": 131072,
        "segments": 1048576}
    assert spmv_kernel.bin_layout(3 * (1 << 20) + 37, 8, (1 << 24) + 5) == {
        "slices": 5, "block_row_bits": 9, "count_blocks": 6145,
        "segments": 30725}


def test_spmv_bin_limits_are_the_sources():
    """The bin layout's limits (``kernels/spmv_ell/ref.py``) are the ones
    ``csrc/spmv_ell.cu`` stages and checks: its ``kBlockEntries`` and
    ``kMaxSlices``."""
    source = (ROOT / "src" / "repro_torch" / "csrc" / "spmv_ell.cu").read_text()
    limits = dict(re.findall(r"constexpr int (k\w+) = (\d+);", source))
    assert int(limits["kBlockEntries"]) == spmv_ref.BLOCK_ENTRIES
    assert int(limits["kMaxSlices"]) == spmv_ref.MAX_SLICES
    assert spmv_kernel.SLICE_BITS == spmv_ref.SLICE_BITS


@pytest.mark.parametrize("n", [1, 2048, 1 << 30, 2**31 - 1])
def test_md5_unwinds_every_search(n):
    assert md5_kernel.md5_route(n) == "unwind"


@pytest.mark.parametrize("kernel,fn,routes", [
    (gemm_kernel, "gemm_cuda", ("wgmma", "pipe", "fma")),
    (flash_kernel, "flash_attention_cuda", ("wgmma", "fma")),
    (decode_kernel, "decode_attention_cuda", ("mma", "fma")),
    (corr_kernel, "correlate_cuda", ("tri", "fma")),
    (wkv_kernel, "wkv6_cuda", ("chunk", "fma")),
    (lru_kernel, "rg_lru_cuda", ("chunk", "fma")),
    (km_kernel, "kmeans_cuda", ("private", "fma")),
    (spmv_kernel, "spmv_ell_cuda", ("bin", "fma")),
    (md5_kernel, "md5_search_cuda", ("unwind", "fma")),
])
def test_two_route_wrappers_count_launches_by_route(kernel, fn, routes):
    """Each multi-route wrapper has its own routes, the first kernel
    (``"fma"``) last, and counts its launches by route."""
    wrapper = getattr(kernel, fn)
    assert kernel.ROUTES == routes
    assert set(wrapper.routes) == set(kernel.ROUTES)
    assert all(isinstance(n, int) for n in wrapper.routes.values())


GEMM_ROUTES = ("wgmma", "pipe", "fma")


@pytest.mark.parametrize("route,chosen,routes,want", [
    (None, "wgmma", GEMM_ROUTES, "wgmma"), (None, "fma", GEMM_ROUTES, "fma"),
    ("fma", "wgmma", GEMM_ROUTES, "fma"), ("fma", "fma", GEMM_ROUTES, "fma"),
    ("wgmma", "wgmma", GEMM_ROUTES, "wgmma"),
    ("wgmma", "fma", GEMM_ROUTES, ValueError),
    ("mma", "wgmma", GEMM_ROUTES, ValueError),
    ("pipe", "pipe", GEMM_ROUTES, "pipe"), ("fma", "pipe", GEMM_ROUTES, "fma"),
    ("pipe", "wgmma", GEMM_ROUTES, ValueError),
    ("pipe", "fma", GEMM_ROUTES, ValueError),
    ("mma", "mma", ("mma", "fma"), "mma"), ("fma", "mma", ("mma", "fma"), "fma"),
    ("mma", "fma", ("mma", "fma"), ValueError),
    ("wgmma", "mma", ("mma", "fma"), ValueError),
    (None, "tri", ("tri", "fma"), "tri"), ("fma", "tri", ("tri", "fma"), "fma"),
    ("tri", "fma", ("tri", "fma"), ValueError),
    ("chunk", "tri", ("tri", "fma"), ValueError),
    (None, "chunk", ("chunk", "fma"), "chunk"),
    ("fma", "chunk", ("chunk", "fma"), "fma"),
    ("chunk", "chunk", ("chunk", "fma"), "chunk"),
    ("chunk", "fma", ("chunk", "fma"), ValueError),
    ("tri", "chunk", ("chunk", "fma"), ValueError),
    (None, "private", ("private", "fma"), "private"),
    ("fma", "private", ("private", "fma"), "fma"),
    ("private", "private", ("private", "fma"), "private"),
    ("private", "fma", ("private", "fma"), ValueError),
    ("chunk", "private", ("private", "fma"), ValueError),
    (None, "bin", ("bin", "fma"), "bin"),
    ("fma", "bin", ("bin", "fma"), "fma"),
    ("bin", "fma", ("bin", "fma"), ValueError),
    ("unwind", "unwind", ("unwind", "fma"), "unwind"),
    ("fma", "unwind", ("unwind", "fma"), "fma"),
    ("bin", "unwind", ("unwind", "fma"), ValueError),
])
def test_a_named_route_is_taken_only_where_it_can_run(route, chosen, routes,
                                                      want):
    """The first kernel can always be named (to time it on the same
    inputs); another route only where the route function chose it, and
    only among the wrapper's own routes."""
    if want is ValueError:
        with pytest.raises(ValueError, match="does not take these inputs"):
            common.resolve_route(route, chosen, routes, "gemm")
    else:
        assert common.resolve_route(route, chosen, routes, "gemm") == want


@pytest.mark.parametrize("err,match", [
    (-1, "refused a TMA tensor map \\(CUresult 1\\)"),
    (700, "CUDA launch failed with error code 700"),
])
def test_a_failed_launch_or_tensor_map_raises(err, match):
    with pytest.raises(RuntimeError, match=match):
        _build.check(err, "gemm (wgmma)")
    _build.check(0, "gemm (wgmma)")


HEADER = _build.CSRC_DIR / "hopper.cuh"


def _wgmma_wrappers():
    """(function, N, source A, register list, trailing operands) of every
    wgmma wrapper written out in hopper.cuh."""
    text = HEADER.read_text()
    found = []
    for m in re.finditer(
            r"void (wgmma_(ss|rs)(\d+))\(.*?m64n(\d+)k16\.f32\.bf16\.bf16 "
            r"\{\"(.*?)\"\}, (.*?);\\n\}\\n\"", text, re.DOTALL):
        regs = re.findall(r"%(\d+)", m.group(5))
        found.append((m.group(1), int(m.group(3)), int(m.group(4)),
                      m.group(2), [int(r) for r in regs], m.group(6)))
    return found


#: the shapes the two kernels issue: the GEMM's m64n256k16 (B MN-major),
#: attention's scores m64n{64,128}k16 and its P V m64n{64,128}k16 (P from
#: registers)
WRAPPERS = ["wgmma_ss64", "wgmma_ss128", "wgmma_ss256", "wgmma_rs64",
            "wgmma_rs128"]


def test_header_writes_out_the_wgmma_shapes_the_kernels_issue():
    assert sorted(f for f, *_ in _wgmma_wrappers()) == sorted(WRAPPERS)


@pytest.mark.parametrize("name", WRAPPERS)
def test_header_wgmma_operands_are_numbered_in_order(name):
    """Each wrapper names its N / 2 accumulator registers %0..%(N/2 - 1) in
    order, and the operands after them by the numbers that follow: a
    misnumbered operand list would still assemble and compute garbage."""
    (_, n, n_inst, src, regs, rest), = [w for w in _wgmma_wrappers()
                                        if w[0] == name]
    assert n == n_inst
    r = n // 2
    assert regs == list(range(r))
    if src == "ss":  # desc_a, desc_b, p (scale_d), trans-b immediate
        assert rest == f"%{r}, %{r + 1}, p, 1, 1, 0, %{r + 3}"
        scale = r + 2
    else:  # A's four registers, desc_b, p (scale_d), B transposed
        assert rest == (f"{{%{r}, %{r + 1}, %{r + 2}, %{r + 3}}}, %{r + 4}, "
                        "p, 1, 1, 1")
        scale = r + 5
    text = HEADER.read_text()
    body = text[text.index(f"void {name}("):]
    body = body[:body.index("\n}\n")]
    assert f"setp.ne.b32 p, %{scale}, 0;" in body
    assert body.count("HOPPER_D32(") == r // 32


def test_header_edits_rebuild_the_library(tmp_path, monkeypatch):
    """The build's key covers hopper.cuh, so an edit of the header alone
    rebuilds the kernels that include it."""
    for p in _build.CSRC_DIR.iterdir():
        (tmp_path / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    srcs = _build.sources()
    before = _build._digest(srcs)
    (tmp_path / "hopper.cuh").write_text(HEADER.read_text() + "\n// edit\n")
    assert _build._digest(srcs) != before


@pytest.mark.parametrize("what,n,eps2,route", [
    ("the main path's 2^17 bodies", 1 << 17, 1e-3, "tile"),
    ("chip_smoke's ragged tile", 4133, 1e-3, "tile"),
    ("at the size threshold", 512, 1e-3, "tile"),
    ("below it", 511, 1e-3, "fma"),
    ("chip_smoke's n = 300", 300, 1e-3, "fma"),
    ("eps^2 = 0: NaN self terms, kept as in the reference", 1 << 17, 0.0,
     "fma"),
    ("a subnormal eps^2", 1 << 17, 1e-39, "fma"),
    ("eps^2 = FLT_MIN", 1 << 17, nbody_kernel.FLT_MIN, "tile"),
    ("just below FLT_MIN as a float32", 1 << 17, 1.1754942e-38, "fma"),
    ("a negative eps^2", 1 << 17, -1e-3, "fma"),
])
def test_nbody_route(what, n, eps2, route):
    """Route "tile"'s unguarded rsqrt is exact only where every |d|^2 +
    eps^2 is a normal float: eps^2 >= FLT_MIN (as the kernel's float32)."""
    posm = torch.zeros((n, 4))
    assert nbody_kernel.nbody_route(posm, eps2) == route, what


def test_nbody_route_names_and_counts():
    assert nbody_kernel.ROUTES[-1] == "fma"
    assert set(nbody_kernel.nbody_cuda.routes) == set(nbody_kernel.ROUTES)
    with pytest.raises(ValueError, match="does not take these inputs"):
        common.resolve_route("tile", "fma", nbody_kernel.ROUTES, "nbody")
    assert common.resolve_route("fma", "tile", nbody_kernel.ROUTES,
                                "nbody") == "fma"


def test_nbody_tile_constants_are_the_sources():
    """kernel.py's tile, targets a thread and fold are ``csrc/nbody.cu``'s
    kThreads, kTileTargets and kTileFold (the wrapper cuts the slices in
    whole tiles, and the probe times the package's instance by them)."""
    src = (ROOT / "src" / "repro_torch" / "csrc" / "nbody.cu").read_text()

    def const(name):
        return re.search(rf"constexpr \w+ {name} = (\w+);", src).group(1)

    assert int(const("kThreads")) == nbody_kernel.TILE
    assert int(const("kTileTargets")) == nbody_kernel.TILE_TARGETS
    assert (const("kTileFold") == "true") == nbody_kernel.TILE_FOLD

#!/usr/bin/env python3
"""The redesigned CUDA-core routes alone: the correlator's ``"tri"``,
WKV6's and RG-LRU's ``"chunk"``, K-Means' ``"private"``, SpMV's ``"bin"``
and MD5's ``"unwind"``, built, checked, timed, with the chunk lengths,
K-Means' points a thread, SpMV's slices and n and MD5's forms swept.

    PYTHONPATH=src python3 tools/cuda_core_probe.py [--no-time] [--reps 5]
        [--kernels correlate,wkv6,rg_lru,kmeans,spmv,md5,nbody]
        [--lengths 16,32,64,128,256]
        [--lru-lengths 32,64,128,256] [--points 1,2,4,8]

Needs one GPU.  Builds ``src/repro_torch/csrc`` and prints what ``ptxas``
says of the two routes' kernels (``correlate_tri_kernel``;
``wkv6_deltas_kernel``, ``wkv6_carry_kernel``, ``wkv6_outputs_kernel``):
registers, spills, and their tensor-core instructions in the SASS (there
must be none: both routes are f32 on the CUDA cores).  Then it holds each
against its plain version with ``chip_smoke.py``'s checks: the correlator
at (C, T, A) = (1024, 768, 256) and ragged A (200, 65, 129, 128), f32
within ``CORR_TOL`` and bf16 within the bf16 limit of the f32 plain
version, the mirrored tiles bit-exactly the conjugates of their
transposes, and the tiles on and above the diagonal bit-equal to route
``"fma"``'s; WKV6 at rwkv6-3b's prefill (1, 40, 2048, 64) and ragged T, K
and V, with decays of exactly 0 and 1, at every chunk length of the sweep
(f32 within ``SCAN_TOL`` of the plain version and of ``wkv6_chunked_ref``,
bf16 within the bf16 limit).  Unless ``--no-time``, and only when every
case passed, it times in turns within this one run: the correlator by
routes ``"tri"`` and ``"fma"`` and by cuBLAS's complex product; WKV6 at
the prefill shape in bf16 by route ``"fma"`` and by route ``"chunk"`` at
each chunk length (device time of calls queued behind a sleep), each
pass's device time by ``torch.profiler``, the decode shape (8, 40, 1, 64)
by route ``"fma"``, and both routes at prompts of 128 to 1024 tokens
(where the chunks start to pay).

RG-LRU's route ``"chunk"`` (``rg_lru_local_kernel``,
``rg_lru_outputs_kernel``) is held against the plain version (f32 within
``SCAN_TOL``, and of ``rg_lru_chunked_ref`` at the same L; bf16 within the
bf16 limit) at recurrentgemma-2b's prefill (1, 2048, 2560), its window
check (1, 2600, 2560), ragged T and D with log_a of exactly 0 and -50, and
T = 4170 (over 64 chunks, so L grows), at every chunk length of
``--lru-lengths``.  Timed: the prefill shape in bf16 by route ``"fma"`` and
by ``"chunk"`` at each length, each pass's device time by
``torch.profiler``, both routes at prompts of 32 to 2048 tokens, and the
decode step (8, 1, 2560) by ``"fma"``.

K-Means' route ``"private"`` (``kmeans_private_kernel``) is held against the
plain version (counts exactly equal, sums within rtol 1e-4 atol 1e-3) at
(n, f, k) = (2^26, 4, 40), the stream chunk (2^22, 4, 40) and ragged n, k
and f (2, 4, 8, 16).  The probe's variants come from ``csrc/kmeans.cu``
built again with ``KMEANS_PROBE`` into ``build/repro_torch/kmeans_probe/``
(the package's library holds none of them): route ``"private"`` at f = 4
with ``--points`` points a thread, each held to the plain version too.
Timed at both main shapes, kernel launches alone: the first kernel (route
``"fma"``) in full, with its sums cut (counts only) and with all
accumulation cut (the distance loop alone), and each variant of route
``"private"``, with and without its accumulation.  The SASS lines of the
K-Means kernels' shared atomics are printed.

SpMV (``--kernels spmv``): both routes and route ``"fma"``'s ablations,
built from ``csrc/spmv_ell.cu`` again with ``SPMV_PROBE`` into
``build/repro_torch/spmv_probe/``, held against the plain version (rtol
1e-5, atol 1e-6, NaN in the same rows) at (2^25, 16) with n = 2^25, at
each slice size of route ``"bin"``, and on a ragged shape route ``"bin"``
takes with columns out of range and NaN in x under zero entries.  Timed
in turns: (a) the first kernel gathering every entry, (b) the same with
every column taken mod 2^22 (x's reads in 16 MiB of L2), (c) the gather
skipped where data == 0, (d) the gather replaced by a constant, route
``"fma"`` (the finite pass and (c)) and route ``"bin"``; route ``"bin"``
at each slice size and by pass (``torch.profiler``); both routes over the
rows from 2^12 to 2^25 at n = 2^25 and over n from 2^20 to 2^25 (where
route ``"bin"`` starts to pay, for ``BIN_MIN_ROWS`` and ``BIN_MIN_N``).

MD5 (``--kernels md5``): the SASS pipe mix (ALU opcodes against IMAD
forms) of route ``"fma"``, route ``"unwind"`` and route ``"unwind"``'s
forms, built from ``csrc/md5.cu`` with ``MD5_PROBE`` into
``build/repro_torch/md5_probe/`` (adds on the ALU or the FMA pipe, the
rotate-add as IMAD.HI + IMAD; one, two or four keys a thread); each finds
the planted keys (n = 2^30 with the key 4099 below n, n = 2048 with keys
0 and 1500, and none); all timed in turns at n = 2^30 beside the time the
first kernel's 202 instructions a key take on the ALU pipe alone.

N-Body (``--kernels nbody``): route ``"tile"`` (several targets a thread,
the sources in slices, ``rsqrt.approx.ftz``), built from ``csrc/nbody.cu``
again with ``NBODY_PROBE`` into ``build/repro_torch/nbody_probe/`` at 1, 2,
4 and 8 targets a thread, eps^2 folded into |d|^2's first multiply-add or
not, each at 1, 2, 4 and 8 slices; every variant and both routes held
against the f32 plain version within ``2e-4 * sum |term|`` at n = 2^17,
4133 (a ragged last tile, every 7th mass zero) and 1000, route ``"tile"``
also against float64, and each variant's bit-equality with route
``"fma"`` reported.  Each instance's issue slots a pair in its inner loop
(``chip_smoke.loop_slots``: FP32-pipe instructions, MUFU, LDS).  Timed in
turns at n = 2^17: (a) route ``"fma"``, (b) the ftz rsqrt alone (one
target, one slice), (c) four targets and four slices, (d) (c) with eps^2
folded, every variant, route ``"tile"``; then both routes over n (for
``TILE_MIN_N``).

One JSON line per step; then the card's name and power limit; exit 1 if a
case failed.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import re
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

from chip_smoke import (  # noqa: E402
    FULL,
    KERNEL_HOST_S,
    SCAN_TOL,
    TENSOR_CORE_OPS,
    check_close,
    corr_check,
    corr_inputs,
    corr_work,
    kernel_device_ms,
    kmeans_check,
    kmeans_inputs,
    lru_check,
    lru_exact_decays,
    lru_inputs,
    lru_plain,
    lru_work,
    NBODY_FLOPS_PER_PAIR,
    NBODY_RAGGED_TILE,
    loop_slots,
    md5_digest,
    md5_int_ops_per_key,
    md5_work,
    mirrored_tiles,
    nbody_inputs,
    nbody_ordered_floor_ms,
    nbody_slab_check,
    nbody_term_scale,
    sass_text,
    ptxas_usage,
    require,
    sass_instructions,
    spmv_bin_inputs,
    spmv_check,
    spmv_inputs,
    time_ms,
    wkv_check,
    wkv_exact_decays,
    wkv_inputs,
    wkv_work,
)
from repro_torch.kernels import (  # noqa: E402
    _build,
    correlate_ref,
    kmeans_assign_reduce_ref,
    wkv6_ref,
)
from repro_torch.kernels.common import (  # noqa: E402
    H100_SXM_FP32_FLOPS,
    H100_SXM_INT32_ALU_OPS,
    cdiv,
    sm_count,
    stride_grid,
)
from repro_torch.kernels.correlator.kernel import (  # noqa: E402
    correlate_cuda,
)
from repro_torch.kernels.md5.kernel import md5_search_cuda  # noqa: E402
from repro_torch.kernels.md5.ref import (  # noqa: E402
    md5_unwind,
    md5_word1_target,
)
from repro_torch.kernels.nbody import kernel as nbody_kernel  # noqa: E402
from repro_torch.kernels.nbody.kernel import nbody_cuda  # noqa: E402
from repro_torch.kernels.nbody.ref import (  # noqa: E402
    nbody_forces_ref,
    nbody_slices,
)
from repro_torch.kernels.spmv_ell import kernel as spmv_kernel  # noqa: E402
from repro_torch.kernels.spmv_ell.ref import spmv_ell_ref  # noqa: E402
from repro_torch.kernels.kmeans.kernel import (  # noqa: E402
    BLOCKS_PER_SM as KM_FMA_BLOCKS_PER_SM,
    THREADS as KM_THREADS,
    kmeans_cuda,
    points_per_thread,
    private_grid,
)
from repro_torch.kernels.rg_lru.kernel import (  # noqa: E402
    CHUNK_LEN as LRU_CHUNK_LEN,
    MAX_CHUNKS as LRU_MAX_CHUNKS,
    MIN_CHUNKS,
    chunk_steps,
    rg_lru_cuda,
)
from repro_torch.kernels.rg_lru.ref import rg_lru_chunked_ref  # noqa: E402
from repro_torch.kernels.rwkv6.kernel import CHUNK_LEN, wkv6_cuda  # noqa: E402
from repro_torch.kernels.rwkv6.ref import wkv6_chunked_ref  # noqa: E402

KERNELS = ("correlate_tri_kernel", "wkv6_deltas_kernel", "wkv6_carry_kernel",
           "wkv6_outputs_kernel")
LRU_KERNELS = ("rg_lru_local_kernel", "rg_lru_outputs_kernel")
KM_KERNELS = ("kmeans_private_kernel", "kmeans_kernel")
SPMV_KERNELS = ("spmv_ell_kernel", "spmv_finite_kernel",
                "spmv_bin_scatter_kernel", "spmv_bin_gather_kernel")
MD5_KERNELS = ("md5_search_kernel", "md5_unwind_kernel")
NBODY_KERNELS = ("nbody_kernel", "nbody_tile_kernel", "nbody_combine_kernel")
F32, BF16 = torch.float32, torch.bfloat16
#: (C, T, A, dtype) of the correlator's checks
CORR_CASES = [(1024, 768, 256, F32), (1024, 768, 256, BF16),
              (3, 77, 200, F32), (3, 77, 200, BF16), (2, 33, 65, F32),
              (2, 33, 65, BF16), (1, 40, 129, BF16), (2, 100, 128, F32)]
#: (B, H, T, K, V, dtype, exact decays) of WKV6's checks
WKV_CASES = [(1, 40, 2048, 64, 64, BF16, False),
             (1, 40, 2048, 64, 64, F32, False),
             (1, 4, 300, 64, 64, F32, False), (1, 4, 300, 64, 64, BF16, False),
             (2, 3, 161, 64, 50, F32, False), (2, 3, 161, 64, 50, BF16, False),
             (2, 2, 200, 20, 50, F32, False), (1, 4, 300, 64, 64, F32, True)]
#: (B, T, D, dtype, exact decays) of RG-LRU's checks
LRU_CASES = [(1, 2048, 2560, BF16, False), (1, 2048, 2560, F32, False),
             (1, 2600, 2560, BF16, False), (2, 300, 100, F32, False),
             (2, 300, 100, BF16, False), (3, 161, 2560, BF16, False),
             (2, 300, 100, F32, True), (2, 300, 100, BF16, True),
             (1, 4170, 100, F32, False)]
#: (n, k, f) of K-Means' checks; the first two are timed
KM_CASES = [(1 << 26, 40, 4), (1 << 22, 40, 4), (1000, 7, 4), (5001, 9, 2),
            (3000, 5, 8), (2000, 6, 16), (100_003, 40, 4)]
#: where the probe builds ``kmeans.cu``, ``spmv_ell.cu`` and ``md5.cu``
#: with their variants (the package's library holds none of them)
KM_PROBE_DIR = _build.build_dir() / "kmeans_probe"
SPMV_PROBE_DIR = _build.build_dir() / "spmv_probe"
MD5_PROBE_DIR = _build.build_dir() / "md5_probe"
NBODY_PROBE_DIR = _build.build_dir() / "nbody_probe"
_probe_libs: dict[str, tuple] = {}
#: route "fma"'s forms in the probe's build of ``spmv_ell.cu``
#: (``Mode`` in the source)
SPMV_MODES = {"skip zeros": 0, "gather all": 1, "constant": 2}
#: route "unwind"'s forms in the probe's build of ``md5.cu``: (its rounds'
#: ``UnwindMode`` in the source, keys a thread)
MD5_MODES = {f"{label}, {keys} key{'s' * (keys > 1)} a thread": (mode, keys)
             for label, mode, keys_swept in (
                 ("adds on alu", 0, (1, 2, 4)), ("adds on fma", 1, (1, 2, 4)),
                 ("rotate on fma", 2, (1, 2)))
             for keys in keys_swept}
#: SpMV's main shape: rows, max_nnz, n
SPMV_MAIN = (1 << 25, 16, 1 << 25)
#: route "bin"'s slices swept (log2 of their columns), the package's first
SPMV_TILES = [spmv_kernel.SLICE_BITS, 21, 23, 24]
#: SpMV's n swept for route "bin"'s threshold (rows and max_nnz of the
#: main shape), and its rows (max_nnz and n of the main shape)
SPMV_NS = [1 << b for b in range(20, 26)]
SPMV_ROWS = [1 << b for b in range(12, 26)]
#: route "tile"'s variants in the probe's build of ``nbody.cu``: (targets a
#: thread, slices of the sources, eps^2 folded)
NBODY_VARIANTS = [(r, s, f) for f in (False, True) for r in (1, 2, 4, 8)
                  for s in (1, 2, 4, 8)]
#: the variants the predictions name: (b) the ftz rsqrt alone, (c) four
#: targets a thread over four slices, (d) (c) with eps^2 folded
NBODY_NAMED = {"(b) ftz rsqrt": (1, 1, False), "(c) R=4 S=4": (4, 4, False),
               "(d) R=4 S=4 folded": (4, 4, True)}
#: bodies of N-Body's checks (the first is timed) and of the n sweep
NBODY_CASES = [1 << 17, NBODY_RAGGED_TILE, 1000]
NBODY_NS = [1 << b for b in range(8, 16)]
#: the ALU pipe's opcodes in the MD5 kernels' SASS (the rest of their
#: integer work is IMAD, on the FMA pipe)
ALU_OPS = ("LOP3", "IADD3", "LEA", "SHF", "ISETP", "PRMT")


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check_corr(c, t, a, dtype, gen, device) -> dict:
    (x,) = corr_inputs(c, t, a, gen, device, dtype)
    before = correlate_cuda.routes["tri"]
    got = correlate_cuda(x)
    require(correlate_cuda.routes["tri"] == before + 1, "not route tri")
    first = correlate_cuda(x, route="fma")
    torch.cuda.synchronize()
    err = corr_check(f"correlate/{[c, t, a]}", got,
                     correlate_ref(x) if dtype == F32 else None, x)
    upper = ~mirrored_tiles(a, device)
    same = bool(torch.equal(got[:, upper], first[:, upper]))
    require(same, "the tiles i <= j differ from route fma's")
    return {"max_abs_err": err[0], "upper_tiles_equal_fma": same}


def check_wkv(shape, exact, lengths, gen, device) -> dict:
    b, h, t, dk, dv, dtype = shape
    inputs = wkv_inputs(b, h, t, dk, dv, dtype, gen, device)
    if exact:
        inputs = wkv_exact_decays(inputs)
    want = wkv6_ref(*inputs, return_state=True)
    out = {}
    for length in lengths:
        if t < 2 * length:
            continue
        got = wkv6_cuda(*inputs, route="chunk", chunk_len=length)
        torch.cuda.synchronize()
        res = wkv_check(f"wkv6/{list(shape)} L={length}", got, want, *inputs)
        row = {"max_abs_err": res[0]}
        if dtype == F32:
            chunked = wkv6_chunked_ref(*inputs, chunk_len=length,
                                       return_state=True)
            row["vs_chunked_ref"] = max(
                check_close(f"wkv6 L={length}/chunked ref", g, w,
                            rtol=SCAN_TOL, atol=SCAN_TOL)[0]
                for g, w in zip(got, chunked))
        else:
            row.update(res[2])
        out[length] = row
    return out


def check_lru(shape, exact, lengths, gen, device) -> dict:
    b, t, d, dtype = shape
    inputs = lru_inputs(b, t, d, dtype, gen, device)
    if exact:
        inputs = lru_exact_decays(inputs)
    want = lru_plain(*inputs)
    out = {}
    for length in lengths:
        if t < MIN_CHUNKS * length:
            continue
        got = rg_lru_cuda(*inputs, route="chunk", chunk_len=length)
        torch.cuda.synchronize()
        steps = chunk_steps(t, length)  # the L the kernel ran with
        tag = f"L={steps}"
        res = lru_check(f"rg_lru/{list(shape)} {tag}", got, want, *inputs)
        row = {"max_abs_err": res[0]}
        if dtype == F32:
            chunked = rg_lru_chunked_ref(*inputs, chunk_len=steps,
                                         return_state=True)
            row["vs_chunked_ref"] = max(
                check_close(f"rg_lru {tag}/chunked ref", g, w,
                            rtol=SCAN_TOL, atol=SCAN_TOL)[0]
                for g, w in zip(got, chunked))
        else:
            row.update(res[2])
        out[tag] = row
    return out


def probe_lib(src: str, define: str, out) -> ctypes.CDLL:
    """The probe's build of ``csrc/<src>`` with ``-D<define>`` into
    ``out``, built and loaded once a process."""
    return probe_build(src, define, out)[1]


def probe_build(src: str, define: str, out) -> tuple:
    """(path, loaded library) of ``probe_lib``'s build."""
    if src not in _probe_libs:
        path = _build.build([_build.CSRC_DIR / src], (define,), out)
        _probe_libs[src] = (path, ctypes.CDLL(str(path)))
    return _probe_libs[src]


def probe_fn(lib: ctypes.CDLL, name: str, argtypes):
    fn = getattr(lib, name)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def km_probe(name, argtypes):
    """A launcher of the probe's build of ``kmeans.cu``."""
    return probe_fn(probe_lib("kmeans.cu", "KMEANS_PROBE", KM_PROBE_DIR),
                    name, argtypes)


def km_first_ablation(points, centroids, accum):
    """The first kernel with its accumulation cut (``accum`` 1: counts
    only; 2: nothing), on route "fma"'s grid; partials."""
    n = points.shape[0]
    k = centroids.shape[0]
    grid = max(1, min(cdiv(n, KM_THREADS),
                      KM_FMA_BLOCKS_PER_SM * sm_count(points.device.index)))
    sums = torch.empty((grid, k, 4), dtype=F32, device=points.device)
    counts = torch.empty((grid, k), dtype=torch.int32, device=points.device)
    fn = km_probe("kmeans_first_ablation_f32", [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    err = fn(points.data_ptr(), centroids.data_ptr(), sums.data_ptr(),
             counts.data_ptr(), n, k, grid, accum,
             torch.cuda.current_stream().cuda_stream)
    _build.check(err, "kmeans first kernel ablation")
    return sums, counts


def km_variant(points, centroids, accum, per_thread):
    """A variant of route "private" at f = 4 (with its accumulation or,
    ``accum`` False, without), on its own one-wave grid; partials."""
    n, k = points.shape[0], centroids.shape[0]
    blocks = km_probe("kmeans_probe_blocks_per_sm", [ctypes.c_int] * 3)(
        k, int(accum), per_thread)
    if blocks < 1:
        _build.check(-blocks, f"kmeans probe occupancy P={per_thread}")
    grid = private_grid(n, per_thread, blocks, points.device)
    sums = torch.empty((grid, k, 4), dtype=F32, device=points.device)
    counts = torch.empty((grid, k), dtype=torch.int32, device=points.device)
    fn = km_probe("kmeans_probe_partials_f32", [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    err = fn(points.data_ptr(), centroids.data_ptr(), sums.data_ptr(),
             counts.data_ptr(), n, k, grid, int(accum), per_thread,
             torch.cuda.current_stream().cuda_stream)
    _build.check(err, f"kmeans private accum={accum} P={per_thread}")
    return sums, counts


def check_kmeans(n, k, f, points_swept, gen, device) -> dict:
    points, centroids = kmeans_inputs(n, k, f, gen, device)
    want = kmeans_assign_reduce_ref(points, centroids)
    before = kmeans_cuda.routes["private"]
    got = tuple(x.sum(dim=0) for x in kmeans_cuda(points, centroids))
    require(kmeans_cuda.routes["private"] == before + 1, "not route private")
    got = (got[0], got[1].to(F32))
    torch.cuda.synchronize()
    row = {"route": kmeans_check(f"kmeans/{[n, f, k]}", got, want,
                                 points)[0]}
    if f == 4:
        for p in points_swept:
            sums, counts = km_variant(points, centroids, True, p)
            got = (sums.sum(dim=0), counts.sum(dim=0).to(F32))
            row[f"P={p}"] = kmeans_check(f"kmeans/{[n, f, k]} P={p}", got,
                                         want, points)[0]
    return row


def atomics_in_sass(lib, names) -> dict:
    """The SASS lines of shared and global atomics in the kernels
    ``names`` (the first few of each instance)."""
    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()),
                             "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    out, fn = {}, None
    for ln in text.splitlines():
        if "Function : " in ln:
            fn = ln.split("Function : ")[1].strip()
            fn = fn if any(nm in fn for nm in names) else None
            continue
        if fn and re.search(r"\b(ATOMS|ATOM|RED)\b", ln):
            lines = out.setdefault(fn, [])
            if len(lines) < 6:
                lines.append(" ".join(ln.split()[1:4]))
    return out


def spmv_ablation(data, cols, x, mode: int, nonfinite) -> torch.Tensor:
    """Route "fma"'s kernel in one of ``SPMV_MODES`` (the probe's build),
    with the finite flag ``nonfinite`` given, not computed."""
    rows, nnz = data.shape
    vec = (nnz % 4 == 0 and data.data_ptr() % 16 == 0
           and cols.data_ptr() % 16 == 0)
    y = torch.empty((rows,), dtype=F32, device=data.device)
    fn = probe_fn(probe_lib("spmv_ell.cu", "SPMV_PROBE", SPMV_PROBE_DIR),
                  "spmv_ell_probe_f32", [ctypes.c_void_p] * 4 + [
                      ctypes.c_longlong] + [ctypes.c_int] * 4 + [
                      ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    err = fn(data.data_ptr(), cols.data_ptr(), x.data_ptr(), y.data_ptr(),
             rows, nnz, x.shape[0], spmv_kernel.lanes_per_row(nnz, vec),
             int(vec), nonfinite.data_ptr(), mode,
             torch.cuda.current_stream().cuda_stream)
    _build.check(err, f"spmv_ell probe mode {mode}")
    return y


@contextlib.contextmanager
def patched(module, **values):
    """The module's constants set to ``values`` for the block (the probe
    sweeps a route's sizes and thresholds this way)."""
    saved = {k: getattr(module, k) for k in values}
    for k, v in values.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(module, k, v)


def spmv_by_tiles(data, cols, x, slice_bits) -> torch.Tensor:
    """Route "bin" with slices of 2^slice_bits columns."""
    with patched(spmv_kernel, SLICE_BITS=slice_bits):
        return spmv_kernel.spmv_ell_cuda(data, cols, x, route="bin")


def spmv_close(name, got, want) -> float:
    return spmv_check(name, got, want)[0]


def check_spmv(gen, device) -> dict:
    """Both routes and every ablation against the plain version at the
    main shape, each tile size of the sweep, and the ragged shape with NaN
    planted in x under zero entries."""
    data, cols, x = spmv_inputs(*SPMV_MAIN, gen, device)
    want = spmv_ell_ref(data, cols, x)
    flag = torch.zeros((1,), dtype=torch.int32, device=device)
    out = {}
    before = spmv_kernel.spmv_ell_cuda.routes["bin"]
    out["bin"] = spmv_close("spmv bin", spmv_kernel.spmv_ell_cuda(
        data, cols, x), want)
    require(spmv_kernel.spmv_ell_cuda.routes["bin"] == before + 1,
            "the main shape did not take route bin")
    out["fma"] = spmv_close("spmv fma", spmv_kernel.spmv_ell_cuda(
        data, cols, x, route="fma"), want)
    for label in ("skip zeros", "gather all"):
        out[label] = spmv_close(f"spmv {label}", spmv_ablation(
            data, cols, x, SPMV_MODES[label], flag), want)
    out["constant"] = spmv_close("spmv constant", spmv_ablation(
        data, cols, x, SPMV_MODES["constant"], flag),
        (data * (cols & 1).float()).sum(dim=1))
    modded = cols % (1 << 22)
    out["columns mod 2^22"] = spmv_close("spmv cols mod 2^22", spmv_ablation(
        data, modded, x, SPMV_MODES["gather all"], flag),
        spmv_ell_ref(data, modded, x))
    del modded
    for tiles in SPMV_TILES[1:]:
        out[f"bin slice 2^{tiles}"] = spmv_close(
            f"spmv bin {tiles}", spmv_by_tiles(data, cols, x, tiles), want)
    del data, cols, x, want
    torch.cuda.empty_cache()
    data, cols, x = spmv_bin_inputs(FULL.spmv_bin_ragged, gen, device,
                                    nan_under_zeros=True)
    want = spmv_ell_ref(data, cols, x)
    require(bool(torch.isnan(want).any()), "no NaN planted")
    before = spmv_kernel.spmv_ell_cuda.routes["bin"]
    out["ragged bin, NaN under zeros"] = spmv_close(
        "spmv ragged bin", spmv_kernel.spmv_ell_cuda(data, cols, x), want)
    require(spmv_kernel.spmv_ell_cuda.routes["bin"] == before + 1,
            "the ragged shape did not take route bin")
    out["ragged fma, NaN under zeros"] = spmv_close(
        "spmv ragged fma", spmv_kernel.spmv_ell_cuda(data, cols, x,
                                                      route="fma"), want)
    return out


def time_spmv(reps, gen, device):
    """The ablations and both routes at the main shape in turns, each
    route "bin" tile size, route "bin"'s passes by ``torch.profiler``, and
    both routes over n (rows and max_nnz of the main shape)."""
    data, cols, x = spmv_inputs(*SPMV_MAIN, gen, device)
    flag = torch.zeros((1,), dtype=torch.int32, device=device)
    modded = cols % (1 << 22)
    runs = {
        "(a) first kernel, every entry gathered": lambda: spmv_ablation(
            data, cols, x, SPMV_MODES["gather all"], flag),
        "(b) columns mod 2^22 (x's reads in 16 MiB of L2)":
            lambda: spmv_ablation(data, modded, x,
                                  SPMV_MODES["gather all"], flag),
        "(c) gather skipped where data == 0": lambda: spmv_ablation(
            data, cols, x, SPMV_MODES["skip zeros"], flag),
        "(d) gather replaced by a constant": lambda: spmv_ablation(
            data, cols, x, SPMV_MODES["constant"], flag),
        "route fma (finite pass + (c))": lambda: spmv_kernel.spmv_ell_cuda(
            data, cols, x, route="fma"),
        "route bin": lambda: spmv_kernel.spmv_ell_cuda(data, cols, x),
    }
    rounds = [{k: time_ms(fn, device, reps) for k, fn in runs.items()}
              for _ in range(2)]
    tiles = {f"slice 2^{t}": time_ms(
        lambda t=t: spmv_by_tiles(data, cols, x, t), device, reps)
        for t in SPMV_TILES}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            spmv_kernel.spmv_ell_cuda(data, cols, x)
        torch.cuda.synchronize()
    passes = {k: (kernel_device_ms(prof, k) or 0.0) / reps
              for k in ("spmv_finite_kernel", "spmv_bin_scatter_kernel",
                        "spmv_bin_gather_kernel")}
    del modded
    by_n, by_rows = {}, {}
    with patched(spmv_kernel, BIN_MIN_N=1, BIN_MIN_ROWS=1):
        # route bin at every n and every row count of the sweeps
        for rows in SPMV_ROWS:
            by_rows[rows] = {route: time_ms(
                lambda r=route: spmv_kernel.spmv_ell_cuda(
                    data[:rows], cols[:rows], x, route=r),
                device, reps) for route in ("fma", "bin")}
        del x
        for n in SPMV_NS:
            xn = torch.rand((n,), generator=gen, device=device)
            cn = torch.randint(0, n, cols.shape, generator=gen, device=device,
                               dtype=torch.int32)
            by_n[n] = {route: time_ms(
                lambda r=route: spmv_kernel.spmv_ell_cuda(data, cn, xn,
                                                          route=r),
                device, reps) for route in ("fma", "bin")}
            del xn, cn
    emit({"step": "time", "kernel": "spmv_ell", "shape": list(SPMV_MAIN),
          "ms": rounds, "bin_by_tiles": tiles, "bin_pass_device_ms": passes,
          "by_rows": by_rows, "by_n": by_n,
          "bin_device_bytes": data.numel() * 8})


def md5_probe_search(n, target, form: tuple, device) -> torch.Tensor:
    """Route "unwind" in one of ``MD5_MODES``' forms (the probe's build of
    md5.cu)."""
    state = md5_unwind(target)
    found = torch.full((1,), n, dtype=torch.int32, device=device)
    fn = probe_fn(probe_lib("md5.cu", "MD5_PROBE", MD5_PROBE_DIR),
                  "md5_unwind_probe_u32", [ctypes.c_uint32] * 6 + [
                      ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int, ctypes.c_void_p])
    err = fn(n, *state, md5_word1_target(state), found.data_ptr(),
             stride_grid(n, found.device), *form,
             torch.cuda.current_stream().cuda_stream)
    _build.check(err, f"md5 unwind probe {form}")
    return found


def sass_pipe_mix(lib, names) -> dict:
    """Each instance of the kernels ``names``: its opcodes with their
    modifiers (a static count), the ALU pipe's (``ALU_OPS``) and the IMAD
    forms (the FMA pipe's) summed."""
    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()),
                             "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    out, ops = {}, None
    for ln in text.splitlines():
        head = re.search(r"Function : (\S+)", ln)
        if head:
            fn = head.group(1)
            name = next((nm for nm in names if nm in fn), None)
            ops = None
            if name:
                key = f"{name}#{sum(k.startswith(name) for k in out)}"
                ops = out.setdefault(key, {})
            continue
        inst = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?"
                        r"([A-Z][A-Z0-9_.]*)", ln)
        if inst and ops is not None:
            ops[inst.group(1)] = ops.get(inst.group(1), 0) + 1
    return {fn: {"alu": sum(v for o, v in o_.items()
                            if o.split(".")[0] in ALU_OPS),
                 "imad": sum(v for o, v in o_.items()
                             if o.split(".")[0] == "IMAD"),
                 "total": sum(o_.values()), "opcodes": dict(sorted(
                     o_.items()))}
            for fn, o_ in out.items()}


def check_md5(device) -> dict:
    """Route "fma", route "unwind" and each form of its rounds find the
    planted keys: n = 2^30 with the key 4099 below n, n = 2048 with keys 0
    and 1500, and no match."""
    big = 1 << 30
    cases = [(big, md5_digest(big - 4099), big - 4099),
             (2048, md5_digest(0), 0), (2048, md5_digest(1500), 1500),
             (2048, (1, 2, 3, 4), 2048)]
    out = {}
    for n, target, expect in cases:
        got = {"fma": int(md5_search_cuda(n, target, device, route="fma")),
               "unwind": int(md5_search_cuda(n, target, device))}
        for label, form in MD5_MODES.items():
            got[label] = int(md5_probe_search(n, target, form, device))
        require(set(got.values()) == {expect}, "md5", n, expect, got)
        out[f"n={n} key={expect}"] = got
    return out


def time_md5(reps, device):
    """Both routes and every form of route "unwind" at n = 2^30 in turns,
    beside the time the first kernel's 202 instructions a key take on the
    ALU pipe alone (64 lanes a clock on each SM)."""
    n = 1 << 30
    target = md5_digest(n - 4099)
    runs = {"fma": lambda: md5_search_cuda(n, target, device, route="fma"),
            "unwind": lambda: md5_search_cuda(n, target, device)}
    for label, form in MD5_MODES.items():
        runs[f"unwind, {label}"] = (
            lambda f=form: md5_probe_search(n, target, f, device))
    rounds = [{k: time_ms(fn, device, reps) for k, fn in runs.items()}
              for _ in range(2)]
    emit({"step": "time", "kernel": "md5", "n": n, "ms": rounds,
          "first_kernel_on_alu_pipe_ms": 202 * n / H100_SXM_INT32_ALU_OPS
          * 1e3,
          "bound_instructions_a_key": md5_int_ops_per_key(),
          "bound_ms": md5_work(n)[0]})


def nbody_variant(posm, variant: tuple) -> torch.Tensor:
    """Route "tile" at ``(targets, slices, folded)`` (the probe's build of
    nbody.cu), eps^2 the default."""
    targets, slices, fold = variant
    n = posm.shape[0]
    ranges = nbody_slices(n, slices, nbody_kernel.TILE)
    acc = torch.empty((n, 3), dtype=torch.float32, device=posm.device)
    partial = (torch.empty((len(ranges), n, 3), dtype=torch.float32,
                           device=posm.device) if len(ranges) > 1 else acc)
    fn = probe_fn(probe_lib("nbody.cu", "NBODY_PROBE", NBODY_PROBE_DIR),
                  "nbody_tile_probe_f32", [
                      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_int, ctypes.c_float, ctypes.c_int,
                      ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    err = fn(posm.data_ptr(), acc.data_ptr(), partial.data_ptr(), n,
             nbody_kernel.SOFTENING2, len(ranges),
             ranges[0][1] - ranges[0][0], targets, int(fold),
             torch.cuda.current_stream().cuda_stream)
    _build.check(err, f"nbody tile probe {variant}")
    return acc


def nbody_instance_slots(text: str) -> dict:
    """``loop_slots`` of each N-Body instance, keyed by route "tile"'s
    template arguments (``R=4 folded`` ...) or the kernel's name."""
    out = {}
    for name in NBODY_KERNELS[:2]:
        for fn, slots in loop_slots(text, name).items():
            args = re.search(r"ILi(\d+)ELb([01])E", fn)
            key = (f"R={args.group(1)}" + " folded" * (args.group(2) == "1")
                   if args else name)
            out[key] = slots
    return out


def check_nbody(n, gen, device) -> dict:
    """Both routes and every variant against the f32 plain version within
    ``2e-4 * sum |term|`` (every target), route "tile" also against float64
    within 1e-4 on a slab of 1024 targets; which variants equal route
    "fma" bit for bit."""
    posm, _ = nbody_inputs(n, gen, device,
                           zero_every=7 if n == NBODY_RAGGED_TILE else 0)
    want = nbody_forces_ref(posm)
    scale = torch.cat([nbody_term_scale(posm, lo, min(n, lo + 1024))
                       for lo in range(0, n, 1024)])
    fma = nbody_cuda(posm, route="fma")
    runs = {"fma": fma, **{str(v): nbody_variant(posm, v)
                           for v in NBODY_VARIANTS}}
    if n >= nbody_kernel.TILE_MIN_N:
        runs["tile"] = nbody_cuda(posm)
    worst, equal = {}, {}
    for label, got in runs.items():
        share = float(((got - want).abs() / scale).max()) / 2e-4
        require(torch.isfinite(got).all() and share <= 1, "nbody", n, label,
                "off by", share, "of the limit")
        worst[label] = share
        equal[label] = torch.equal(got, fma)
    out = {"limit_share": worst, "bit_equal_to_fma": equal}
    if "tile" in runs:
        lo = max(0, n // 2 - 512)
        hi = min(n, lo + 1024)
        out["tile_vs_float64"] = nbody_slab_check(
            f"nbody {n} tile", runs["tile"][lo:hi], want[lo:hi], posm, lo,
            hi)
    return out


def time_nbody(reps, gen, device):
    """At n = 2^17, in turns: route "fma", the named variants, every
    variant, route "tile"; then both routes over ``NBODY_NS``."""
    n = 1 << 17
    posm, _ = nbody_inputs(n, gen, device)
    runs = {"(a) fma": lambda: nbody_cuda(posm, route="fma")}
    for label, v in NBODY_NAMED.items():
        runs[label] = lambda v=v: nbody_variant(posm, v)
    for v in NBODY_VARIANTS:
        runs[f"R={v[0]} S={v[1]}" + " folded" * v[2]] = (
            lambda v=v: nbody_variant(posm, v))
    runs["route tile"] = lambda: nbody_cuda(posm)
    rounds = [{k: time_ms(fn, device, reps) for k, fn in runs.items()}
              for _ in range(2)]
    by_n = {}
    for m in NBODY_NS:
        p, _ = nbody_inputs(m, gen, device)
        by_n[m] = {"fma": time_ms(lambda: nbody_cuda(p, route="fma"), device,
                                  reps, queued=KERNEL_HOST_S),
                   "tile": time_ms(lambda: nbody_variant(
                       p, (nbody_kernel.TILE_TARGETS, nbody_kernel.TILE_SLICES,
                           nbody_kernel.TILE_FOLD)), device, reps,
                       queued=KERNEL_HOST_S)}
    emit({"step": "time", "kernel": "nbody", "n": n, "ms": rounds,
          "by_n": by_n,
          "bound_ms": NBODY_FLOPS_PER_PAIR * float(n) ** 2
          / H100_SXM_FP32_FLOPS * 1e3,
          "ordered_floor_ms": nbody_ordered_floor_ms(n)})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--no-time", action="store_true")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--lengths", default="16,32,64,128,256",
                    help="WKV6 chunk lengths to check and time")
    ap.add_argument("--lru-lengths", default="32,64,128,256",
                    help="RG-LRU chunk lengths to check and time")
    ap.add_argument("--points", default="1,2,4,8,16",
                    help="K-Means points a thread of route private's variants")
    ap.add_argument("--kernels",
                    default="correlate,wkv6,rg_lru,kmeans,spmv,md5,nbody",
                    help="which kernels to check and time")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("cuda_core_probe: needs a GPU", file=sys.stderr)
        return 1
    lengths = sorted({int(x) for x in args.lengths.split(",")} | {CHUNK_LEN})
    lru_lengths = sorted({int(x) for x in args.lru_lengths.split(",")}
                         | {LRU_CHUNK_LEN})
    points_swept = sorted({int(x) for x in args.points.split(",")}
                          | {points_per_thread(4)})
    which = set(args.kernels.split(","))
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=device).manual_seed(args.seed)
    lib = _build.build()
    sass = sass_instructions(lib)
    names = KERNELS + LRU_KERNELS + KM_KERNELS
    emit({"step": "build", "nvcc_seconds": _build.build_seconds,
          "ptxas": ptxas_usage(_build.build_log(), names),
          "sass": {fn: {"total": ops["total"], "FFMA": ops.get("FFMA", 0),
                        "ATOMS": ops.get("ATOMS", 0),
                        **{o: ops.get(o, 0) for o in TENSOR_CORE_OPS}}
                   for fn, ops in sass.items()
                   if fn.split("#")[0] in names},
          "kmeans_atomics": atomics_in_sass(lib, KM_KERNELS)})
    if "kmeans" in which:
        # the probe's own build of kmeans.cu, with its variants
        km_lib = _build.build([_build.CSRC_DIR / "kmeans.cu"],
                              ("KMEANS_PROBE",), KM_PROBE_DIR)
        emit({"step": "build kmeans probe",
              "nvcc_seconds": _build.build_seconds,
              "ptxas": ptxas_usage(_build.build_log(KM_PROBE_DIR),
                                   KM_KERNELS),
              "kmeans_atomics": atomics_in_sass(km_lib, KM_KERNELS)})
    if "spmv" in which:
        spmv_lib = probe_build("spmv_ell.cu", "SPMV_PROBE", SPMV_PROBE_DIR)[0]
        emit({"step": "build spmv probe", "ptxas": ptxas_usage(
            _build.build_log(SPMV_PROBE_DIR), SPMV_KERNELS),
            "sass": sass_pipe_mix(spmv_lib, SPMV_KERNELS),
            "atomics": atomics_in_sass(spmv_lib, SPMV_KERNELS)})
    if "nbody" in which:
        nbody_lib = probe_build("nbody.cu", "NBODY_PROBE",
                                NBODY_PROBE_DIR)[0]
        emit({"step": "build nbody probe", "ptxas": ptxas_usage(
            _build.build_log(NBODY_PROBE_DIR), NBODY_KERNELS),
            "package_slots_per_pair": nbody_instance_slots(sass_text(lib)),
            "probe_slots_per_pair": nbody_instance_slots(
                sass_text(nbody_lib))})
    if "md5" in which:
        md5_lib = probe_build("md5.cu", "MD5_PROBE", MD5_PROBE_DIR)[0]
        emit({"step": "build md5 probe", "ptxas": ptxas_usage(
            _build.build_log(MD5_PROBE_DIR), MD5_KERNELS),
            "package_sass": sass_pipe_mix(lib, MD5_KERNELS),
            "probe_sass": sass_pipe_mix(md5_lib, MD5_KERNELS)})

    failed = []

    def run_check(name, fn):
        try:
            emit({"step": "check", "case": name, **fn()})
        except Exception as e:  # a probe reports every case
            failed.append(name)
            emit({"step": "check", "case": name, "failed": repr(e)[:2000]})
        torch.cuda.empty_cache()

    for c, t, a, dtype in CORR_CASES if "correlate" in which else []:
        name = f"correlate {[c, t, a]} {dtype}"
        try:
            emit({"step": "check", "case": name,
                  **check_corr(c, t, a, dtype, gen, device)})
        except Exception as e:  # a probe reports every case
            failed.append(name)
            emit({"step": "check", "case": name, "failed": repr(e)[:2000]})
        torch.cuda.empty_cache()
    for *shape, exact in WKV_CASES if "wkv6" in which else []:
        name = f"wkv6 {shape[:5]} {shape[5]}" + (" exact decays" * exact)
        try:
            emit({"step": "check", "case": name,
                  "by_chunk_len": check_wkv(shape, exact, lengths, gen,
                                            device)})
        except Exception as e:
            failed.append(name)
            emit({"step": "check", "case": name, "failed": repr(e)[:2000]})
        torch.cuda.empty_cache()
    for *shape, exact in LRU_CASES if "rg_lru" in which else []:
        run_check(f"rg_lru {shape[:3]} {shape[3]}" + (" exact decays" * exact),
                  lambda: {"by_chunk": check_lru(shape, exact, lru_lengths,
                                                 gen, device)})
    for n, k, f in KM_CASES if "kmeans" in which else []:
        run_check(f"kmeans {[n, f, k]}",
                  lambda: check_kmeans(n, k, f, points_swept, gen, device))
    if "spmv" in which:
        run_check("spmv", lambda: check_spmv(gen, device))
    if "md5" in which:
        run_check("md5", lambda: check_md5(device))
    for n in NBODY_CASES if "nbody" in which else []:
        run_check(f"nbody {n}", lambda: check_nbody(n, gen, device))

    if failed:
        emit({"step": "verdict", "failed": failed})
    elif not args.no_time:
        reps = args.reps
        if "correlate" in which:
            time_corr(reps, gen, device)
        if "wkv6" in which:
            time_wkv(reps, lengths, gen, device)
        if "rg_lru" in which:
            time_lru(reps, lru_lengths, gen, device)
        if "kmeans" in which:
            time_kmeans(reps, points_swept, gen, device)
        if "spmv" in which:
            time_spmv(reps, gen, device)
        if "md5" in which:
            time_md5(reps, device)
        if "nbody" in which:
            time_nbody(reps, gen, device)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    return 1 if failed else 0


def time_corr(reps, gen, device):
    (x,) = corr_inputs(1024, 768, 256, gen, device)
    xc = torch.view_as_complex(x)
    corr = {"tri": lambda: correlate_cuda(x),
            "fma": lambda: correlate_cuda(x, route="fma"),
            "cublas": lambda: torch.matmul(xc.mT, xc.conj())}
    rounds = [{k: time_ms(fn, device, reps) for k, fn in corr.items()}
              for _ in range(2)]
    emit({"step": "time", "kernel": "correlate", "shape": [1024, 768, 256],
          "ms": rounds, "bound_ms": corr_work(x)})
    del x, xc, corr
    torch.cuda.empty_cache()


def time_wkv(reps, lengths, gen, device):
    inputs = wkv_inputs(1, 40, 2048, 64, 64, BF16, gen, device)
    runs = {"fma": lambda: wkv6_cuda(*inputs, route="fma")}
    for length in lengths:
        runs[f"chunk L={length}"] = (
            lambda n=length: wkv6_cuda(*inputs, route="chunk",
                                       chunk_len=n))
    rounds = [{k: time_ms(fn, device, reps, queued=KERNEL_HOST_S)
               for k, fn in runs.items()} for _ in range(2)]
    passes = {}
    for length in lengths:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                runs[f"chunk L={length}"]()
            torch.cuda.synchronize()
        passes[length] = {k: (kernel_device_ms(prof, k) or 0.0) / reps
                          for k in KERNELS[1:]}
    # Where the chunks start to pay: both routes at shorter prompts.
    short = {}
    for t in (128, 256, 512, 1024):
        x = wkv_inputs(1, 40, t, 64, 64, BF16, gen, device)
        short[t] = {route: time_ms(
            lambda rt=route: wkv6_cuda(*x, route=rt), device, reps,
            queued=KERNEL_HOST_S) for route in ("fma", "chunk")}
    dec = wkv_inputs(8, 40, 1, 64, 64, BF16, gen, device)
    decode = [time_ms(lambda: wkv6_cuda(*dec), device, reps,
                      queued=KERNEL_HOST_S) for _ in range(2)]
    emit({"step": "time", "kernel": "wkv6", "shape": [1, 40, 2048, 64],
          "ms": rounds, "pass_device_ms": passes, "by_prompt": short,
          "bound_ms": wkv_work(*inputs), "decode_fma_ms": decode,
          "decode_bound_ms": wkv_work(*dec)})


def time_lru(reps, lengths, gen, device):
    """RG-LRU at recurrentgemma-2b's prefill by both routes, the chunked
    one at each length (device time of calls queued behind a
    sleep), each pass by ``torch.profiler``; both routes by prompt length;
    the decode step."""
    inputs = lru_inputs(1, 2048, 2560, BF16, gen, device)
    runs = {"fma": lambda: rg_lru_cuda(*inputs, route="fma")}
    for length in lengths:
        runs[f"chunk L={length}"] = (
            lambda n=length: rg_lru_cuda(*inputs, route="chunk",
                                         chunk_len=n))
    rounds = [{k: time_ms(fn, device, reps, queued=KERNEL_HOST_S)
               for k, fn in runs.items()} for _ in range(2)]
    passes = {}
    for key, fn in runs.items():
        if key == "fma":
            continue
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        passes[key] = {k: (kernel_device_ms(prof, k) or 0.0) / reps
                       for k in LRU_KERNELS}
    # Where the chunks start to pay: both routes by prompt length (chunks
    # of at most a MIN_CHUNKS-th of the prompt).
    by_prompt = {}
    for t in (32, 64, 96, 128, 192, 256, 512, 1024, 2048):
        x = lru_inputs(1, t, 2560, BF16, gen, device)
        length = min(LRU_CHUNK_LEN, t // MIN_CHUNKS)
        by_prompt[t] = {"chunk_len": length, **{
            route: time_ms(lambda rt=route: rg_lru_cuda(
                *x, route=rt, chunk_len=length), device, reps,
                queued=KERNEL_HOST_S)
            for route in ("fma", "chunk")}}
    dec = lru_inputs(8, 1, 2560, BF16, gen, device)
    decode = [time_ms(lambda: rg_lru_cuda(*dec), device, reps,
                      queued=KERNEL_HOST_S) for _ in range(2)]
    emit({"step": "time", "kernel": "rg_lru", "shape": [1, 2048, 2560],
          "max_chunks": LRU_MAX_CHUNKS, "ms": rounds,
          "pass_device_ms": passes,
          "by_prompt": by_prompt, "bound_ms": lru_work(*inputs),
          "decode_fma_ms": decode, "decode_bound_ms": lru_work(*dec)})


def time_kmeans(reps, points_swept, gen, device):
    """K-Means kernel launches alone at the launch phase's and the stream
    chunk's shapes: the first kernel in full and with its accumulation cut,
    and every variant of route "private"."""
    for n in (1 << 26, 1 << 22):
        points, centroids = kmeans_inputs(n, 40, 4, gen, device)
        runs = {"fma": lambda: kmeans_cuda(points, centroids, route="fma"),
                "fma counts only": lambda: km_first_ablation(
                    points, centroids, 1),
                "fma none": lambda: km_first_ablation(points, centroids, 2),
                "private": lambda: kmeans_cuda(points, centroids)}
        for accum, label in ((True, "thread"), (False, "none")):
            for p in points_swept:
                runs[f"private {label} P={p}"] = (
                    lambda a=accum, q=p: km_variant(points, centroids, a, q))
        rounds = [{k: time_ms(fn, device, reps) for k, fn in runs.items()}
                  for _ in range(2)]
        emit({"step": "time", "kernel": "kmeans", "shape": [n, 4, 40],
              "route_points_per_thread": points_per_thread(4),
              "ms": rounds})
        del points, centroids
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())

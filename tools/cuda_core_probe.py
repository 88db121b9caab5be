#!/usr/bin/env python3
"""The redesigned CUDA-core routes alone: the correlator's ``"tri"``,
WKV6's and RG-LRU's ``"chunk"`` and K-Means' ``"private"``, built, checked,
timed, with the chunk lengths and K-Means' points a thread swept.

    PYTHONPATH=src python3 tools/cuda_core_probe.py [--no-time] [--reps 5]
        [--kernels correlate,wkv6,rg_lru,kmeans] [--lengths 16,32,64,128,256]
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

One JSON line per step; then the card's name and power limit; exit 1 if a
case failed.
"""

from __future__ import annotations

import argparse
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
    mirrored_tiles,
    ptxas_usage,
    require,
    sass_instructions,
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
from repro_torch.kernels.common import cdiv, sm_count  # noqa: E402
from repro_torch.kernels.correlator.kernel import (  # noqa: E402
    correlate_cuda,
)
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
#: where the probe builds ``kmeans.cu`` with its variants
KM_PROBE_DIR = _build.build_dir() / "kmeans_probe"
_km_lib: ctypes.CDLL | None = None


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


def km_probe(name, argtypes):
    """A launcher of the probe's build of ``kmeans.cu``."""
    global _km_lib
    if _km_lib is None:
        _km_lib = ctypes.CDLL(str(_build.build(
            [_build.CSRC_DIR / "kmeans.cu"], ("KMEANS_PROBE",),
            KM_PROBE_DIR)))
    fn = getattr(_km_lib, name)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


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
    ap.add_argument("--kernels", default="correlate,wkv6,rg_lru,kmeans",
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

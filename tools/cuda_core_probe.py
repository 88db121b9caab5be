#!/usr/bin/env python3
"""The correlator's route ``"tri"`` and WKV6's route ``"chunk"`` alone:
built, checked, timed, and WKV6's chunk length swept.

    PYTHONPATH=src python3 tools/cuda_core_probe.py [--no-time] [--reps 5]
        [--lengths 16,32,64,128,256]

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
(where the chunks start to pay).  One JSON line per step; then the card's
name and power limit; exit 1 if a case failed.
"""

from __future__ import annotations

import argparse
import json
import os
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
from repro_torch.kernels import _build, correlate_ref, wkv6_ref  # noqa: E402
from repro_torch.kernels.correlator.kernel import (  # noqa: E402
    correlate_cuda,
)
from repro_torch.kernels.rwkv6.kernel import CHUNK_LEN, wkv6_cuda  # noqa: E402
from repro_torch.kernels.rwkv6.ref import wkv6_chunked_ref  # noqa: E402

KERNELS = ("correlate_tri_kernel", "wkv6_deltas_kernel", "wkv6_carry_kernel",
           "wkv6_outputs_kernel")
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--no-time", action="store_true")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--lengths", default="16,32,64,128,256",
                    help="WKV6 chunk lengths to check and time")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("cuda_core_probe: needs a GPU", file=sys.stderr)
        return 1
    lengths = sorted({int(x) for x in args.lengths.split(",")} | {CHUNK_LEN})
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=device).manual_seed(args.seed)
    lib = _build.build()
    sass = sass_instructions(lib)
    emit({"step": "build", "nvcc_seconds": _build.build_seconds,
          "ptxas": ptxas_usage(_build.build_log(), KERNELS),
          "sass": {fn: {"total": ops["total"], "FFMA": ops.get("FFMA", 0),
                        **{o: ops.get(o, 0) for o in TENSOR_CORE_OPS}}
                   for fn, ops in sass.items()
                   if fn.split("#")[0] in KERNELS}})

    failed = []
    for c, t, a, dtype in CORR_CASES:
        name = f"correlate {[c, t, a]} {dtype}"
        try:
            emit({"step": "check", "case": name,
                  **check_corr(c, t, a, dtype, gen, device)})
        except Exception as e:  # a probe reports every case
            failed.append(name)
            emit({"step": "check", "case": name, "failed": repr(e)[:2000]})
        torch.cuda.empty_cache()
    for *shape, exact in WKV_CASES:
        name = f"wkv6 {shape[:5]} {shape[5]}" + (" exact decays" * exact)
        try:
            emit({"step": "check", "case": name,
                  "by_chunk_len": check_wkv(shape, exact, lengths, gen,
                                            device)})
        except Exception as e:
            failed.append(name)
            emit({"step": "check", "case": name, "failed": repr(e)[:2000]})
        torch.cuda.empty_cache()

    if failed:
        emit({"step": "verdict", "failed": failed})
    elif not args.no_time:
        reps = args.reps
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
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

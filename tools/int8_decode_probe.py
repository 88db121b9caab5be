#!/usr/bin/env python3
"""Decode attention on the int8 KV cache, on one GPU: route "mma" ablated,
and route "gemv" held and timed beside it.

    python3 tools/int8_decode_probe.py [--seed 0] [--reps 20] [--draws 2]

Builds ``src/repro_torch/csrc`` and prints what ``ptxas`` says of the int8
routes' kernels (registers, shared memory, spills).  Holds route "gemv"
against the f32 plain version on the dequantized cache with
``chip_smoke.py``'s ``quant_check`` (the bf16 limit, lse within 1e-4) at
ragged shapes: groups 1, 2 and 4 at D = 128 with T = 300 and 70, D = 64
and 256, a rank's run with empty rows, kv_len 1.

The ablation: variants of route "mma" built from copies of
``csrc/decode_attention_int8.cu`` (and of route "gemv" from copies of
``csrc/decode_attention_int8_gemv.cu``), each edited as below and its
entry points renamed, into one library under ``build/repro_torch/
int8_ablation/`` (the package's library holds none of them; the sources
are not switched):

- ``no_widen``: each warp's slab takes the int8 bytes as they are (the
  widening's PRMT and FADD skipped; wrong results, for timing only);
- ``no_scales``: the scales neither copied nor read (k_s and v_s taken as
  1; wrong results, for timing only);
- ``no_widen_no_scales``: both;
- ``stages2``: a ring of 2 tiles at D = 128, not 3 (results held);

and of route "gemv" at D = 128 and one head (``gemv_<variant>``):

- ``copies_only``: the ring filled and waited on, the arithmetic skipped
  (wrong results, for timing only): the floor of the copies, barriers and
  splits alone;
- ``stages2``, ``stages4``: a ring of 2 or 4 tiles, not 3 (results held).

At qwen1.5-32b's decode shape (8, 40, 40, 2184, 128), kv_len over [1, T],
and at one rank's run of that cache split by sequence over 4 ranks (8, 40,
40, 546, 128), ``--draws`` draws each, in turns up and down: route "gemv"
(the wrapper's plan), route "mma", each variant (route "mma"'s plan), and
the bf16 decode kernel on the cache dequantized to bf16; each time the
device time of calls queued behind a sleep, beside the bound
(``chip_smoke.quant_work``).  Prints ``chip_smoke.py``'s env line, then one
JSON line of results.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.decode_attention import kernel as dk  # noqa: E402

SOURCE = _build.CSRC_DIR / "decode_attention_int8.cu"
GEMV_SOURCE = _build.CSRC_DIR / "decode_attention_int8_gemv.cu"
OUT = _build.build_dir() / "int8_ablation"
ENTRIES = ("decode_attention_int8_fwd", "decode_attention_int8_mma",
           "decode_attention_int8_gemv")

_WIDEN_HEAD = ("__device__ __forceinline__ void widen_int8x16("
               "const uint4& raw,\n" + " " * 46 + "uint8_t* dst) {\n")
_SCALE_COPY = ("      hopper::cp_async4(scales + tid, (tid < BT ? ksb : vsb)\n"
               + " " * 42 + "+ (ok ? t0 + r : t_begin), ok);\n")
_KS_READ = "const float ks_log2 = ksl[n * 8 + (e & 1)] * scale_log2;"
_VS_READ = "const float v0 = vsl[n * 8], v1 = vsl[n * 8 + 1];"
_STAGES = "else if (mt == 1 && D <= 128) fn = &mma::launch<1, 128, 3>;"

#: each variant: (edits of the source as (old, new), results held)
VARIANTS = {
    "no_widen": ([(_WIDEN_HEAD, _WIDEN_HEAD
                   + "  *reinterpret_cast<uint4*>(dst) = raw;\n"
                   "  *reinterpret_cast<uint4*>(dst + 16) = raw;\n"
                   "  return;\n")], False),
    "no_scales": ([(_SCALE_COPY, ""),
                   (_KS_READ, "const float ks_log2 = scale_log2;"),
                   (_VS_READ, "const float v0 = 1.f, v1 = 1.f;")], False),
    "stages2": ([(_STAGES, _STAGES.replace("128, 3>", "128, 2>"))], True),
}
VARIANTS["no_widen_no_scales"] = (VARIANTS["no_widen"][0]
                                  + VARIANTS["no_scales"][0], False)

_GEMV_SKIP = ("    const float* vss = kss + BT;\n\n"
              "    // Scores: each slot's KL lanes")
_GEMV_128_1 = "G <= 1 ? &gemv::launch<128, 1, 3>"
#: variants of route "gemv" at D = 128 and one head, as above
GEMV_VARIANTS = {
    "copies_only": ([(_GEMV_SKIP, _GEMV_SKIP.replace(
        "\n\n", "\n    continue;\n\n"))], False),
    "stages2": ([(_GEMV_128_1, _GEMV_128_1.replace("1, 3>", "1, 2>"))],
                True),
    "stages4": ([(_GEMV_128_1, _GEMV_128_1.replace("1, 3>", "1, 4>"))],
                True),
}

#: (shape, rank's run) of the gemv checks: groups 1, 2, 4 at D = 128, T =
#: 300 and 70; D = 64 and 256; a rank's run with empty rows; kv_len 1
CHECKS = [((3, 4, 4, 300, 128), None, None),
          ((4, 8, 8, 70, 128), None, None),
          ((3, 8, 4, 300, 128), None, None), ((2, 4, 2, 70, 128), None, None),
          ((3, 8, 2, 300, 128), None, None), ((2, 8, 2, 70, 128), None, None),
          ((2, 8, 4, 300, 64), None, None), ((2, 4, 4, 300, 256), None, None),
          ((2, 8, 2, 150, 256), None, None),
          ((4, 8, 8, 70, 128), (1, 3), None),
          ((3, 4, 4, 300, 128), None, 1)]


def variant_sources() -> list:
    """The variants' copies of the source, written under ``OUT``, each with
    its entry points renamed ``<entry>_<variant>``."""
    paths = []
    (OUT / "src").mkdir(parents=True, exist_ok=True)
    for name, (edits, _), source in (
            [(k, v, SOURCE) for k, v in VARIANTS.items()]
            + [(f"gemv_{k}", v, GEMV_SOURCE)
               for k, v in GEMV_VARIANTS.items()]):
        body = source.read_text()
        for old, new in edits:
            if body.count(old) != 1:
                raise RuntimeError(f"variant {name}: {old!r} is not in the "
                                   "source once")
            body = body.replace(old, new)
        for entry in ENTRIES:
            body = body.replace(f'extern "C" int {entry}(',
                                f'extern "C" int {entry}_{name}(')
        path = OUT / "src" / f"int8_{name}.cu"
        path.write_text(body)
        paths.append(path)
    return paths


def ptxas_lines(log: str, names: tuple) -> list:
    """ptxas' entry, register and spill lines of the kernels ``names``."""
    keep, out = False, []
    for ln in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", ln)
        if entry:
            keep = smoke.demangled_name(entry.group(1)) in names
            if keep:
                out.append(entry.group(1))
            continue
        if keep and ("registers" in ln or "spill" in ln):
            out.append(ln.strip())
    return out


def check_gemv(gen, device) -> list:
    rows = []
    for shape, run, kv_len in CHECKS:
        inputs = smoke.quant_inputs(shape, torch.bfloat16, gen, device,
                                    kv_len=kv_len, run=run)
        before = dk.decode_attention_quant_cuda.routes["gemv"]
        got = dk.decode_attention_quant_cuda(*inputs)
        torch.cuda.synchronize()
        smoke.require(dk.decode_attention_quant_cuda.routes["gemv"]
                      == before + 1, shape, "did not take route gemv")
        want = smoke.quant_decode_plain(inputs[0].float(), *inputs[1:],
                                        with_lse=True)
        err = smoke.quant_check(f"gemv/{list(shape)}", got, want, *inputs)
        rows.append({"shape": list(shape), "run": run, "kv_len": kv_len,
                     "max_abs_err": err[0], **err[2]})
    return rows


def variant_call(lib, name, inputs, route="mma"):
    """A call of the variant ``name``'s entry point of ``route``."""
    q, k_q, k_s, v_q, v_s, n = inputs
    symbol = f"decode_attention_int8_{route}_{name}"
    if route == "gemv":
        symbol = f"decode_attention_int8_gemv_gemv_{name}"

    def call():
        out, lse, err = dk._attend(symbol, route, q, (k_q, k_s, v_q, v_s), n,
                                   k_q.shape[1], k_q.shape[2], None, lib=lib)
        _build.check(err, f"variant {name}")
        return out, lse
    return call


def timings(shape, run, lib, gen, device, reps) -> dict:
    """One draw at ``shape``: every call held (the variants that keep the
    results) and timed in turns, up then down."""
    inputs = smoke.quant_inputs(shape, torch.bfloat16, gen, device, run=run)
    q, k_q, k_s, v_q, v_s, n = inputs
    want = smoke.quant_decode_plain(q.float(), k_q, k_s, v_q, v_s, n,
                                    with_lse=True)
    k16 = (k_q.float() * k_s[..., None]).bfloat16()
    v16 = (v_q.float() * v_s[..., None]).bfloat16()
    calls = {
        "gemv": lambda: dk.decode_attention_quant_cuda(*inputs),
        "mma": lambda: dk.decode_attention_quant_cuda(*inputs, route="mma"),
        **{f"mma_{name}": variant_call(lib, name, inputs)
           for name in VARIANTS},
        **{f"gemv_{name}": variant_call(lib, name, inputs, "gemv")
           for name in GEMV_VARIANTS},
        "bf16_cache": lambda: dk.decode_attention_cuda(q, k16, v16, n),
    }
    # the bf16 kernel reads the cache rounded to bf16: a yardstick of time,
    # not held to the int8 cache's lse
    held = {"gemv", "mma"} | {
        f"mma_{name}" for name, (_, keep) in VARIANTS.items() if keep} | {
        f"gemv_{name}" for name, (_, keep) in GEMV_VARIANTS.items() if keep}
    errs = {}
    for label, call in calls.items():
        got = call()
        torch.cuda.synchronize()
        if label in held:
            errs[label] = smoke.quant_check(f"{label}/{list(shape)}", got,
                                            want, *inputs)[2]
    ms = {label: [] for label in calls}
    for order in (list(calls), list(calls)[::-1]):
        for label in order:
            ms[label].append(smoke.time_ms(calls[label], device, reps,
                                           queued=smoke.KERNEL_HOST_S))
    return {"shape": list(shape), "run": run, "kv_len": n.tolist(),
            "bound_ms": smoke.quant_work(*inputs)[0],
            "plans": {r: list(dk.split_plan(shape[0], shape[2], shape[3],
                                            device, r))
                      for r in ("gemv", "mma")},
            "ms": ms, "median_ms": {k: statistics.median(v)
                                    for k, v in ms.items()},
            "limit_shares": errs}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--draws", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("int8_decode_probe: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    t0 = time.perf_counter()
    smoke.emit(smoke.phase_env(device))
    _build.load()
    names = ("decode_int8_gemv_kernel", "decode_int8_mma_kernel")
    res = {"ptxas": ptxas_lines(_build.build_log(), names),
           "nvcc_seconds": _build.build_seconds}
    print("\n".join(res["ptxas"]), file=sys.stderr, flush=True)
    res["gemv_checks"] = check_gemv(gen, device)
    lib = ctypes.CDLL(str(_build.build(variant_sources(), out=OUT)))
    res["variant_ptxas"] = ptxas_lines(_build.build_log(OUT),
                                       ("decode_int8_mma_kernel",
                                        "decode_int8_gemv_kernel"))
    res.update({label: [timings(shape, run, lib, gen, device, args.reps)
                        for _ in range(args.draws)]
                for label, shape, run in (
                    ("qwen", smoke.FULL.decode_qwen_int8, None),
                    ("qwen_seq_rank", smoke.FULL.decode_qwen_int8_seq_rank,
                     (2, 4)))})
    res["seconds"] = time.perf_counter() - t0
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""The redesigned kernels alone: built, checked, then timed.

    PYTHONPATH=src python3 tools/tensor_core_probe.py [--no-time] [--reps 5]

Needs one GPU.  Builds ``src/repro_torch/csrc`` and prints, for the
kernels of the redesigned routes (``"wgmma"``: ``csrc/gemm.cu``,
``csrc/flash_attention.cu``; ``"pipe"``: ``csrc/gemm.cu``; ``"mma"``:
``csrc/decode_attention.cu``), what ``ptxas`` says of their registers and
spills and how many tensor-core instructions (``HGMMA``, ``HMMA``) their
SASS holds.  Then it holds each against its plain version at the main
path's shapes and at ragged ones.  The bf16 kernels against the f32 plain
version of the same bf16 inputs within ``chip_smoke.py``'s bf16 limit
(``bf16_gap``: above 1 fails): the GEMM at 8192^3 and at aligned ragged
shapes, in bf16 and f32 out; flash attention at phi3-mini's prefill,
gemma-2b's MQA shape and ragged, windowed, offset and non-causal cases;
decode attention at phi3-mini's, gemma-2b's and recurrentgemma-2b's decode
shapes and ragged groups, head dims and lengths (lse within 1e-4), at the
wrapper's split plan and at forced split counts, and a row of kv_len 0
(zeros).  The f32 GEMM by route ``"pipe"`` (ragged M and N) against the
f32 plain version
(``GEMM_TOL``), against float64 (1e-4, the reference sweep's) and for
equality with route ``"fma"``.  A failing bf16 case also prints its share
of the limit by 64-column panel and 64-row slab, which tells a wrong
operand layout in the shared-memory descriptors from a wrong mask.  Unless
``--no-time``, and only when every case passed, it times the GEMMs at
8192^3, flash attention at its two main shapes and decode attention at its
three by the redesigned route, by route ``"fma"`` (the first version) and
by one PyTorch call (``torch.matmul``, SDPA), in turns within this one
run.  One JSON line per step; then the card's name and power limit; exit 1
if a case failed.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import subprocess
import sys

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

from chip_smoke import (  # noqa: E402
    GEMM_TOL,
    KERNEL_HOST_S,
    TENSOR_CORE_OPS,
    as_f32,
    bf16_gap,
    bf16_lse_gap,
    close_share,
    decode_inputs,
    decode_work,
    flash_inputs,
    flash_work,
    gemm_inputs,
    sass_instructions,
    sdpa_decode_setup,
    time_ms,
)
from repro_torch.kernels import (  # noqa: E402
    _build,
    attention_ref,
    decode_attention_ref,
    gemm_ref,
)
from repro_torch.kernels.common import (  # noqa: E402
    H100_SXM_BF16_FLOPS,
    H100_SXM_FP32_FLOPS,
    cdiv,
)
from repro_torch.kernels.decode_attention import (  # noqa: E402
    kernel as decode_kernel,
)
from repro_torch.kernels.decode_attention.kernel import (  # noqa: E402
    decode_attention_cuda,
)
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention_cuda,
)
from repro_torch.kernels.gemm.kernel import gemm_cuda  # noqa: E402

GEMM_SHAPES = [(8192, 8192, 8192), (200, 136, 264), (128, 64, 256),
               (64, 8, 512), (300, 1000, 8)]
#: f32 shapes of route "pipe": K a multiple of 16, N of 4, ragged M and N
PIPE_SHAPES = [(8192, 8192, 8192), (200, 144, 260), (129, 256, 516),
               (1, 16, 4), (300, 1008, 12), (64, 32, 2052)]
#: (name, (B, HQ, HKV, T, D), forced split counts) of route "mma"
DECODE_CASES = [
    ("phi3", (8, 32, 32, 2184, 96), (1, 3, 35)),
    ("gemma", (8, 8, 1, 2184, 256), (1, 7, 35)),
    ("recurrentgemma", (8, 10, 1, 2048, 256), (1, 5, 32)),
    ("ragged g10", (3, 10, 1, 300, 256), (1, 2, 5)),
    ("g32 d128", (2, 32, 1, 200, 128), (1, 4)),
    ("g64 d64", (2, 64, 1, 130, 64), (1, 3)),
    ("g40 d64", (2, 40, 1, 130, 64), (2,)),
    ("g2 d16", (2, 4, 2, 100, 16), (1, 2)),
    ("g1 d96 ragged", (8, 32, 32, 300, 96), (1, 5)),
]
FLASH_CASES = [
    ("phi3", (1, 32, 32, 2048, 96), {}),
    ("gemma", (1, 8, 1, 1000, 256), {}),
    ("ragged", (1, 8, 2, 100, 96), {}),
    ("window", (1, 10, 1, 300, 256), {"window": 64}),
    ("offset", (1, 4, 2, 40, 96), {"t": 100, "q_offset": 60}),
    ("d64", (1, 4, 4, 128, 64), {}),
    ("d32_gqa", (2, 8, 2, 200, 32), {}),
    ("noncausal", (1, 4, 2, 70, 128), {"t": 150, "causal": False}),
]


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def by_block(got: torch.Tensor, want: torch.Tensor) -> dict:
    """The worst share of the limit in each 64-column panel and each
    64-row slab of the last two axes (a wrong descriptor spoils whole
    panels; a wrong mask, rows)."""
    cols = [bf16_gap(got[..., j:j + 64], want[..., j:j + 64])["limit_share"]
            for j in range(0, got.shape[-1], 64)]
    rows = [bf16_gap(got[..., i:i + 64, :], want[..., i:i + 64, :])
            ["limit_share"] for i in range(0, got.shape[-2], 64)]
    return {"by_col_panel": cols, "by_row_slab": rows[:32]}


def check(name: str, got: torch.Tensor, want32: torch.Tensor) -> bool:
    gap = bf16_gap(got, want32)
    ok = gap["limit_share"] <= 1.0
    row = {"case": name, "ok": ok, **gap}
    if not ok:
        row.update(by_block(got.float(), want32))
    emit(row)
    return ok


#: the redesigned routes' kernels, by a part of their names
REDESIGNED = r"wgmma|gemm_pipe|decode_mma"


def ptxas_lines() -> list[str]:
    """ptxas' lines for the entry functions of the redesigned routes."""
    out, keep = [], False
    for ln in _build.build_log().splitlines():
        if "Compiling entry function" in ln:
            keep = re.search(REDESIGNED, ln) is not None
        if keep and (re.search(REDESIGNED, ln) or "registers" in ln
                     or "spill" in ln or "warning" in ln.lower()):
            out.append(ln.strip())
    return out


@contextlib.contextmanager
def forced_splits(n: int | None):
    """Decode attention's split plan replaced by ``n`` splits (None: the
    wrapper's own), rounded as the plan rounds, to whole tiles."""
    plan = decode_kernel.split_plan
    if n is not None:
        def fixed(batch, kv_heads, t, device, route="fma"):
            per = cdiv(cdiv(t, decode_kernel.TILE), n)
            return cdiv(cdiv(t, decode_kernel.TILE), per), per
        decode_kernel.split_plan = fixed
    try:
        yield
    finally:
        decode_kernel.split_plan = plan


def decode_check(name: str, got, want32) -> bool:
    """A bf16 decode output within the bf16 limit of the f32 plain version,
    its lse within 1e-4."""
    gap = bf16_gap(got[0], want32[0])
    gap["lse_limit_share"] = bf16_lse_gap(got[1], want32[1])
    ok = max(gap["limit_share"], gap["lse_limit_share"]) <= 1.0
    emit({"case": name, "ok": ok, **gap})
    return ok


def check_decode(gen, dev) -> bool:
    """Route "mma" at every case, by both combines and each split count,
    and a batch with a row of kv_len 0."""
    ok = True
    for name, shape, splits in DECODE_CASES:
        q, k, v, n = decode_inputs(shape, torch.bfloat16, gen, dev)
        want32 = decode_attention_ref(*as_f32((q, k, v)), kv_len=n,
                                      with_lse=True)
        for s in (None, *splits):
            with forced_splits(s):
                before = decode_attention_cuda.routes["mma"]
                got = decode_attention_cuda(q, k, v, n)
                torch.cuda.synchronize()
            assert decode_attention_cuda.routes["mma"] == before + 1
            ok &= decode_check(f"decode {name} {list(shape)} "
                               f"splits={s or 'plan'}", got, want32)
        del q, k, v, want32, got
    q, k, v, n = decode_inputs((3, 10, 1, 300, 256), torch.bfloat16, gen, dev)
    n[1] = 0
    for s in (1, 3):
        with forced_splits(s):
            out, lse = decode_attention_cuda(q, k, v, n)
        empty_ok = bool((out[1] == 0).all()) and bool((lse[1] <= -1e29)
                                                      .all())
        emit({"case": f"decode kv_len 0 splits={s}", "ok": empty_ok})
        ok &= empty_ok
    return ok


def check_pipe(gen, dev) -> bool:
    """Route "pipe" against the f32 plain version (GEMM_TOL), float64 (the
    reference sweep's 1e-4) and route "fma" (the same sums: equal)."""
    ok = True
    for m, k, n in PIPE_SHAPES:
        a, b = gemm_inputs(m, k, n, torch.float32, gen, dev)
        want = gemm_ref(a, b)
        before = gemm_cuda.routes["pipe"]
        got = gemm_cuda(a, b)
        first = gemm_cuda(a, b, route="fma")
        torch.cuda.synchronize()
        assert gemm_cuda.routes["pipe"] == before + 1
        tol = GEMM_TOL[torch.float32]
        want64 = a.double() @ b.double()
        row = {"case": f"pipe {m}x{k}x{n}",
               "plain_share": close_share(got, want, tol, tol),
               "equal_to_fma": bool(torch.equal(got, first)),
               "max_abs_err_plain": float((got - want).abs().max()),
               "f64_share": close_share(got, want64, 1e-4, 1e-4),
               "max_abs_err_f64": float((got.double() - want64).abs().max())}
        row["ok"] = (row["plain_share"] <= 1.0 and row["equal_to_fma"]
                     and row["f64_share"] <= 1.0)
        emit(row)
        ok &= row["ok"]
        del a, b, want, want64, got, first
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--no-time", action="store_true")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tensor_core_probe: needs a GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()
    _build.load()
    sass = sass_instructions(_build.build())
    emit({"step": "build", "nvcc_seconds": _build.build_seconds,
          "ptxas": ptxas_lines(),
          "tensor_cores": {k: {o: v.get(o, 0) for o in TENSOR_CORE_OPS}
                           for k, v in sass.items()
                           if re.search(r"gemm|flash|decode", k)}})

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    ok = True
    for m, k, n in GEMM_SHAPES:
        a, b = gemm_inputs(m, k, n, torch.bfloat16, gen, dev)
        want32 = gemm_ref(a, b, out_dtype=torch.float32)
        for out_dtype in (torch.bfloat16, torch.float32):
            before = gemm_cuda.routes["wgmma"]
            got = gemm_cuda(a, b, out_dtype=out_dtype)
            torch.cuda.synchronize()
            assert gemm_cuda.routes["wgmma"] == before + 1
            ok &= check(f"gemm {m}x{k}x{n} out {out_dtype}", got, want32)
        del a, b, want32, got
    for name, shape, kw in FLASH_CASES:
        q, k, v, kwargs = flash_inputs(shape, torch.bfloat16, gen, dev, **kw)
        before = flash_attention_cuda.routes["wgmma"]
        got = flash_attention_cuda(q, k, v, **kwargs)
        torch.cuda.synchronize()
        assert flash_attention_cuda.routes["wgmma"] == before + 1
        q32, k32, v32, _ = as_f32((q, k, v, kwargs))
        ok &= check(f"flash {name} {list(shape)} {kw}", got,
                    attention_ref(q32, k32, v32, **kwargs))
        del q, k, v, got
    ok &= check_pipe(gen, dev)
    ok &= check_decode(gen, dev)

    if ok and not args.no_time:
        g = GEMM_SHAPES[0]
        a, b = gemm_inputs(*g, torch.bfloat16, gen, dev)
        runs = {}
        for label, fn in (("wgmma", lambda: gemm_cuda(a, b)),
                          ("fma", lambda: gemm_cuda(a, b, route="fma")),
                          ("torch.matmul", lambda: torch.matmul(a, b)),
                          ("wgmma again", lambda: gemm_cuda(a, b))):
            runs[label] = time_ms(fn, dev, args.reps)
        flops = 2.0 * g[0] * g[1] * g[2]
        emit({"step": "time gemm", "shape": list(g), "ms": runs,
              "tflops": {k: flops / v / 1e9 for k, v in runs.items()},
              "bound_ms": flops / H100_SXM_BF16_FLOPS * 1e3})
        del a, b
        for name, shape, kw in FLASH_CASES[:2]:
            q, k, v, kwargs = flash_inputs(shape, torch.bfloat16, gen, dev,
                                           **kw)
            runs = {}
            for label, fn in (
                    ("wgmma", lambda: flash_attention_cuda(q, k, v, **kwargs)),
                    ("fma", lambda: flash_attention_cuda(q, k, v, route="fma",
                                                         **kwargs)),
                    ("sdpa", lambda: F.scaled_dot_product_attention(
                        q, k, v, is_causal=True, enable_gqa=True)),
                    ("wgmma again",
                     lambda: flash_attention_cuda(q, k, v, **kwargs))):
                runs[label] = time_ms(fn, dev, args.reps,
                                      queued=KERNEL_HOST_S)
            emit({"step": f"time flash {name}", "shape": list(shape),
                  "ms": runs, "bound_ms": flash_work(q, k, v, kwargs)[0]})
        a, b = gemm_inputs(*g, torch.float32, gen, dev)
        runs = {}
        for label, fn in (("pipe", lambda: gemm_cuda(a, b)),
                          ("fma", lambda: gemm_cuda(a, b, route="fma")),
                          ("torch.matmul", lambda: torch.matmul(a, b)),
                          ("pipe again", lambda: gemm_cuda(a, b))):
            runs[label] = time_ms(fn, dev, args.reps)
        emit({"step": "time gemm f32", "shape": list(g), "ms": runs,
              "tflops": {k: flops / v / 1e9 for k, v in runs.items()},
              "bound_ms": flops / H100_SXM_FP32_FLOPS * 1e3})
        del a, b
        for name, shape, _ in DECODE_CASES[:3]:
            q, k, v, n = decode_inputs(shape, torch.bfloat16, gen, dev)
            sdpa = sdpa_decode_setup(q, k, v, n)
            runs = {}
            for label, fn in (
                    ("mma", lambda: decode_attention_cuda(q, k, v, n)),
                    ("fma", lambda: decode_attention_cuda(q, k, v, n,
                                                          route="fma")),
                    ("sdpa", lambda: F.scaled_dot_product_attention(
                        sdpa[0], sdpa[1], sdpa[2], attn_mask=sdpa[3],
                        enable_gqa=True)),
                    ("mma again", lambda: decode_attention_cuda(q, k, v, n))):
                runs[label] = time_ms(fn, dev, args.reps,
                                      queued=KERNEL_HOST_S)
            emit({"step": f"time decode {name}", "shape": list(shape),
                  "kv_len": n.tolist(), "ms": runs,
                  "plan": list(decode_kernel.split_plan(
                      shape[0], shape[2], shape[3], dev, "mma")),
                  "bound_ms": decode_work(q, k, v, n)[0]})
            del q, k, v, sdpa
    print(card, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""The two tensor-core kernels alone: built, checked, then timed.

    PYTHONPATH=src python3 tools/tensor_core_probe.py [--no-time] [--reps 5]

Needs one GPU.  Builds ``src/repro_torch/csrc`` and prints, for the
kernels of route ``"wgmma"`` (``csrc/gemm.cu``, ``csrc/flash_attention.cu``),
what ``ptxas`` says of their registers and spills and how many ``HGMMA``
instructions their SASS holds.  Then it holds each against the f32 plain
version of the same bf16 inputs within ``chip_smoke.py``'s bf16 limit
(``bf16_gap``: above 1 fails), at the main path's shapes and at ragged
ones: the GEMM at 8192^3 and at aligned ragged shapes, in bf16 and f32
out; flash attention at phi3-mini's prefill, gemma-2b's MQA shape and
ragged, windowed, offset and non-causal cases.  A failing case also
prints its share of the limit by 64-column panel and 64-row slab, which
tells a wrong operand layout in the shared-memory descriptors from a wrong
mask.  Unless ``--no-time``, and only when every case passed, it times
the GEMM at 8192^3 and flash attention at the two main shapes by route
``"wgmma"``, by route ``"fma"`` (the first version) and by one PyTorch
call (``torch.matmul``, SDPA), in turns within this one run.  One JSON
line per step; then the card's name and power limit; exit 1 if a case
failed.
"""

from __future__ import annotations

import argparse
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
    KERNEL_HOST_S,
    as_f32,
    bf16_gap,
    flash_inputs,
    flash_work,
    gemm_inputs,
    sass_instructions,
    time_ms,
)
from repro_torch.kernels import _build, attention_ref, gemm_ref  # noqa: E402
from repro_torch.kernels.common import H100_SXM_BF16_FLOPS  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention_cuda,
)
from repro_torch.kernels.gemm.kernel import gemm_cuda  # noqa: E402

GEMM_SHAPES = [(8192, 8192, 8192), (200, 136, 264), (128, 64, 256),
               (64, 8, 512), (300, 1000, 8)]
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


def ptxas_lines() -> list[str]:
    """ptxas' lines for the entry functions of route "wgmma"."""
    out, keep = [], False
    for ln in _build.build_log().splitlines():
        if "Compiling entry function" in ln:
            keep = "wgmma" in ln
        if keep and ("wgmma" in ln or "registers" in ln or "spill" in ln
                     or "warning" in ln.lower()):
            out.append(ln.strip())
    return out


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
          "hgmma": {k: v.get("HGMMA", 0) for k, v in sass.items()
                    if re.search(r"gemm|flash", k)}})

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
    print(card, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

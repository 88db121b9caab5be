#!/usr/bin/env python3
"""Decode attention with the cache split over blocks, or not, on one GPU.

    python3 tools/decode_splits.py [--route mma] [--seed 0] [--steps 10]
    python3 tools/decode_splits.py --int8 [--route mma]

Times the decode-attention kernel of ``--route`` (``"mma"``, the tensor
cores, or ``"fma"``, the first kernel; ``src/repro_torch/csrc/
decode_attention.cu``) at the serving paths' shapes (phi3-mini-3.8b: 8
slots x 32 kv heads of 96, T = 2184; recurrentgemma-2b's ring buffer: 8
slots x 10 query heads on 1 kv head of 256, T = 2048; kv_len over [1, T],
``--draws`` draws) and at gemma-2b's MQA shape (8 slots x 1 kv head of
256, T = 2184), with the wrapper's own split plan and with the split
forced to each of several counts; each result is held against the f32
plain version at ``chip_smoke.py``'s bf16 limit.  Then a decode step of phi3-mini-3.8b at full width and depth in
bf16 (random weights from ``--seed``, a cache of random keys and values)
with the plan and with one split, in the order plan, one, one, plan: its
time by CUDA events (the host's issue included) and its device time by
``torch.profiler``; and the wrapper's host time a call with the plan and
with one split.  Prints ``chip_smoke.py``'s env line, then one JSON line
of results.  ``--int8`` times the kernel on the int8 cache instead
(``src/repro_torch/csrc/decode_attention_int8.cu``, its wrapper
``decode_attention_quant_cuda``) at qwen1.5-32b's decode shape (8 slots x
40 kv heads of 128, T = 2184, kv_len over [1, T]) and at one rank's run of
that cache split by sequence over 4 ranks (T = 546, rows that end before
the run empty), by split count as above and held to ``chip_smoke.py``'s
``quant_check``, each split count also for the decode kernel on the same
cache dequantized to bf16; no decode step.  Needs one CUDA device; inputs,
timers and limits are ``chip_smoke.py``'s.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import decode_attention_ref  # noqa: E402
from repro_torch.kernels.common import cdiv  # noqa: E402
from repro_torch.kernels.decode_attention import kernel as dk  # noqa: E402
from repro_torch.models import api as model_api  # noqa: E402

#: split counts to force (rounded, as the plan rounds, to whole tiles)
SPLITS = (1, 2, 3, 5, 9, 18, 35)


@contextlib.contextmanager
def forced_splits(n: int | None):
    """The wrapper's split plan replaced by ``n`` splits (None: its own)."""
    plan = dk.split_plan
    if n is not None:
        def fixed(batch, kv_heads, t, device, route="fma"):
            per = cdiv(cdiv(t, dk.TILE), n)
            return cdiv(cdiv(t, dk.TILE), per), per
        dk.split_plan = fixed
    try:
        yield
    finally:
        dk.split_plan = plan


def host_us(fn, device, calls: int = 200) -> float:
    """Host microseconds to issue one call, while the device sleeps behind
    a long enough wait that no call waits for it."""
    fn()
    smoke.sync(device)
    torch.cuda._sleep(int(calls * 200e-6 * smoke.SM_CLOCK_HZ))
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    spent = time.perf_counter() - t0
    smoke.sync(device)
    return spent / calls * 1e6


def sweep(calls: dict, want, device, reps: int) -> dict:
    """``{label: {split count or "plan": [ms, ms]}}``: each of ``calls``
    (label -> a call giving (out, lse)) at each split count, in turns up
    and down, held to the bf16 limit of the f32 plain version ``want``
    (``chip_smoke.quant_check``, which holds out and lse alike) and
    timed."""
    ms = {label: {} for label in calls}
    for order in (list(SPLITS) + [None], [None] + list(SPLITS)[::-1]):
        for s in order:
            key = "plan" if s is None else str(s)
            with forced_splits(s):
                for label, call in calls.items():
                    smoke.quant_check(f"{label} splits={s}", call(), want)
                    ms[label].setdefault(key, []).append(smoke.time_ms(
                        call, device, reps, queued=smoke.KERNEL_HOST_S))
    return ms


def kernel_times(shape, gen, device, reps: int, route: str) -> dict:
    """One draw of the inputs (kv_len over [1, T]) at ``shape``: each split
    count in turns, up and down."""
    q, k, v, n = smoke.decode_inputs(shape, torch.bfloat16, gen, device)
    want = decode_attention_ref(*smoke.as_f32((q, k, v)), kv_len=n,
                                with_lse=True)
    out = {"shape": list(shape), "kv_len": n.tolist(), "route": route,
           "plan": list(dk.split_plan(shape[0], shape[2], shape[3], device,
                                      route)),
           "bound_ms": smoke.decode_work(q, k, v, n)[0]}

    def call():
        return dk.decode_attention_cuda(q, k, v, n, route=route)

    out.update(sweep({"ms": call}, want, device, reps))
    # The wrapper's host work a call: the plan (scratch, two launches)
    # against one split (one launch).
    for s in (None, 1, 1, None):
        with forced_splits(s):
            us = host_us(call, device)
        out.setdefault("host_us", {}).setdefault(
            "plan" if s is None else str(s), []).append(us)
    return out


def int8_times(shape, gen, device, reps: int, route: str,
               run=None) -> dict:
    """``kernel_times`` for the kernel on the int8 cache (``run``: a rank's
    run of a cache split by sequence, as ``chip_smoke.quant_inputs``
    makes it), with the decode kernel on the cache dequantized to bf16
    timed beside it at each split count."""
    q, k_q, k_s, v_q, v_s, n = smoke.quant_inputs(shape, torch.bfloat16,
                                                  gen, device, run=run)
    want = smoke.quant_decode_plain(q.float(), k_q, k_s, v_q, v_s, n,
                                    with_lse=True)
    k16 = (k_q.float() * k_s[..., None]).bfloat16()
    v16 = (v_q.float() * v_s[..., None]).bfloat16()
    out = {"shape": list(shape), "kv_len": n.tolist(), "route": route,
           "plan": list(dk.split_plan(shape[0], shape[2], shape[3], device,
                                      route)),
           "bound_ms": smoke.quant_work(q, k_q, k_s, v_q, v_s, n)[0]}

    def call():
        return dk.decode_attention_quant_cuda(q, k_q, k_s, v_q, v_s, n,
                                              route=route)

    def bf16_call():
        return dk.decode_attention_cuda(q, k16, v16, n, route=route)

    out.update(sweep({"ms": call, "bf16_cache_ms": bf16_call}, want, device,
                     reps))
    return out


@torch.no_grad()
def step_times(gen, device, steps: int) -> dict:
    cfg = get_config("phi3-mini-3.8b")
    params = model_api.init_params(gen, cfg, device)
    slots, t = 8, 2184
    state = model_api.init_decode_state(cfg, slots, t, device)
    for name in ("k", "v"):
        for layer in state[name]:
            layer.normal_(0.0, 0.5, generator=gen)
    lens = torch.linspace(1, t - 1, slots, device=device).round().int()
    state["pos"].copy_(lens - 1)
    tok = torch.randint(0, cfg.vocab, (slots, 1), generator=gen,
                        device=device, dtype=torch.int32)
    step = lambda: model_api.decode_step(params, tok, cfg, state)  # noqa

    def run(split):
        with forced_splits(split):
            logits = step()[0]
            wall = [smoke.time_ms(step, device, 1, warmup=False)
                    for _ in range(steps)]
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    step()
                smoke.sync(device)
        return logits, {"wall_ms": wall,
                        "device_ms": smoke.device_breakdown(prof, 3)[
                            "device_ms"]}

    out = {"kv_len": lens.tolist(), "plan": None, "one": None}
    runs = {"plan": [], "one": []}
    logits = {}
    for label in ("plan", "one", "one", "plan"):
        logits[label], r = run(None if label == "plan" else 1)
        runs[label].append(r)
    for label, rs in runs.items():
        out[label] = {
            "wall_ms_median": statistics.median(
                w for r in rs for w in r["wall_ms"]),
            "wall_ms": [r["wall_ms"] for r in rs],
            "device_ms": [r["device_ms"] for r in rs]}
    gap = (logits["plan"].double() - logits["one"].double()).abs().max()
    out["logits_max_abs_diff"] = float(gap)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--draws", type=int, default=4,
                    help="draws of kv_len at each shape")
    ap.add_argument("--route", choices=dk.ROUTES, default="mma")
    ap.add_argument("--no-step", action="store_true",
                    help="time the kernel alone, not a decode step")
    ap.add_argument("--int8", action="store_true",
                    help="the kernel on the int8 cache, at qwen1.5-32b's "
                         "shapes (no decode step)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("decode_splits: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    t0 = time.perf_counter()
    res = {"card": smoke.phase_env(device)["card"],
           "sm_count": torch.cuda.get_device_properties(0)
           .multi_processor_count}
    if args.int8:
        res.update({name: [int8_times(shape, gen, device, args.reps,
                                      args.route, run)
                           for _ in range(args.draws)]
                    for name, shape, run in (
                        ("qwen", smoke.FULL.decode_qwen_int8, None),
                        ("qwen_seq_rank",
                         smoke.FULL.decode_qwen_int8_seq_rank, (2, 4)))})
    else:
        res.update({name: [kernel_times(shape, gen, device, args.reps,
                                        args.route)
                           for _ in range(args.draws)]
                    for name, shape in (
                        ("phi3", smoke.FULL.decode),
                        ("gemma", smoke.FULL.decode_gemma),
                        ("recurrentgemma", smoke.FULL.decode_rgemma))})
    if not args.no_step and not args.int8:
        res["step"] = step_times(gen, device, args.steps)
    res["seconds"] = time.perf_counter() - t0
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Decode attention with the cache split over blocks, or not, on one GPU.

    python3 tools/decode_splits.py [--route mma] [--seed 0] [--steps 10]
    python3 tools/decode_splits.py --int8 [--route gemv]

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
cache dequantized to bf16; no decode step.  With ``--route gemv`` route
``"mma"`` is timed beside it at each split count, and the two are timed
by group (1, 2, 4, 6 and 8 query heads a kv head: 48 query heads of 128
over 8 slots, T = 2184, kv_len over [1, T]), each with its own split plan,
in turns; route "gemv" by a copy of ``csrc/decode_attention_int8_gemv.cu``
built into ``build/repro_torch/gemv_groups/`` with an instance of 8 heads
besides the package's 1, 2 and 4 (the package holds no 8: it spills, and
ptxas' report is printed), so that every group takes it.  It prints the
largest group at which "gemv" is the faster, the crossover that sets
``GEMV_MAX_GROUP`` (at most 4, the package's largest instance).  Needs one
CUDA device; inputs, timers and limits are ``chip_smoke.py``'s.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
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
from repro_torch.kernels import _build, decode_attention_ref  # noqa: E402
from repro_torch.kernels.common import cdiv  # noqa: E402
from repro_torch.kernels.decode_attention import kernel as dk  # noqa: E402
from repro_torch.models import api as model_api  # noqa: E402

#: split counts to force (rounded, as the plan rounds, to whole tiles)
SPLITS = (1, 2, 3, 5, 9, 18, 35)
#: groups of the int8 cache's group sweep, and its shape: (B, HQ, T, D)
GROUPS = (1, 2, 4, 6, 8)
GROUP_SHAPE = (8, 48, 2184, 128)


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


def sweep(calls: dict, want, device, reps: int,
          unheld: tuple = ()) -> dict:
    """``{label: {split count or "plan": [ms, ms]}}``: each of ``calls``
    (label -> a call giving (out, lse)) at each split count, in turns up
    and down, held to the bf16 limit of the f32 plain version ``want``
    (``chip_smoke.quant_check``, which holds out and lse alike; not the
    labels ``unheld``) and timed."""
    ms = {label: {} for label in calls}
    for order in (list(SPLITS) + [None], [None] + list(SPLITS)[::-1]):
        for s in order:
            key = "plan" if s is None else str(s)
            with forced_splits(s):
                for label, call in calls.items():
                    if label not in unheld:
                        smoke.quant_check(f"{label} splits={s}", call(),
                                          want)
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

    def bf16_call():  # the bf16 cache has no route "gemv": its "mma"
        return dk.decode_attention_cuda(q, k16, v16, n, route=(
            "mma" if route == "gemv" else route))

    calls = {"ms": call, "bf16_cache_ms": bf16_call}
    if route == "gemv":
        calls["mma_ms"] = lambda: dk.decode_attention_quant_cuda(
            q, k_q, k_s, v_q, v_s, n, route="mma")
    # the bf16 kernel reads the cache rounded to bf16: its lse is not the
    # int8 cache's within 1e-4, so it is timed, not held
    out.update(sweep(calls, want, device, reps, unheld=("bf16_cache_ms",)))
    return out


#: the package's dispatch of route "gemv" at D = 128, and the group sweep's
_DISPATCH = "G <= 4 ? &gemv::launch<128, 4, 3> : nullptr;"
_DISPATCH_8 = ("G <= 4 ? &gemv::launch<128, 4, 3>\n"
               "       : G <= 8 ? &gemv::launch<128, 8, 3> : nullptr;")
GROUPS_DIR = _build.build_dir() / "gemv_groups"


def gemv_groups_lib() -> tuple[ctypes.CDLL, str]:
    """The group sweep's build of route "gemv" (the source with an
    instance of 8 heads at D = 128, its entry point renamed) and what
    ptxas says of that instance."""
    src = (_build.CSRC_DIR / "decode_attention_int8_gemv.cu").read_text()
    if src.count(_DISPATCH) != 1:
        raise RuntimeError("route gemv's dispatch at D = 128 is not as "
                           "the sweep expects")
    src = src.replace(_DISPATCH, _DISPATCH_8).replace(
        'extern "C" int decode_attention_int8_gemv(',
        'extern "C" int decode_attention_int8_gemv_groups(')
    (GROUPS_DIR / "src").mkdir(parents=True, exist_ok=True)
    path = GROUPS_DIR / "src" / "gemv_groups.cu"
    path.write_text(src)
    lib = ctypes.CDLL(str(_build.build([path], out=GROUPS_DIR)))
    log = _build.build_log(GROUPS_DIR).splitlines()
    at = [i for i, ln in enumerate(log)
          if "decode_int8_gemv_kernelILi128ELi8E" in ln]
    return lib, " | ".join(ln.strip() for i in at for ln in log[i:i + 3])


def group_times(gen, device, reps: int) -> dict:
    """Routes "gemv" and "mma" by group at ``GROUP_SHAPE``, each with its
    own split plan, held to ``quant_check`` and timed in turns (gemv, mma,
    mma, gemv); and the crossover: the largest group at which "gemv" is
    the faster, below the first at which it is not."""
    b, hq, t, d = GROUP_SHAPE
    lib, ptxas_8 = gemv_groups_lib()
    out = {"shape": list(GROUP_SHAPE), "groups": {}, "ptxas_8_heads": ptxas_8}
    for g in GROUPS:
        inputs = smoke.quant_inputs((b, hq, hq // g, t, d), torch.bfloat16,
                                    gen, device)
        q, k_q, k_s, v_q, v_s, n = inputs
        want = smoke.quant_decode_plain(q.float(), *inputs[1:],
                                        with_lse=True)

        def gemv():
            got, lse, err = dk._attend(
                "decode_attention_int8_gemv_groups", "gemv", q,
                (k_q, k_s, v_q, v_s), n, k_q.shape[1], t, None, lib=lib)
            _build.check(err, f"gemv group {g}")
            return got, lse

        calls = {"gemv": gemv,
                 "mma": lambda: dk.decode_attention_quant_cuda(*inputs,
                                                               route="mma")}
        ms = {label: [] for label in calls}
        for label in ("gemv", "mma", "mma", "gemv"):
            if not ms[label]:
                smoke.quant_check(f"{label} group {g}", calls[label](),
                                  want, *inputs)
            ms[label].append(smoke.time_ms(calls[label], device, reps,
                                           queued=smoke.KERNEL_HOST_S))
        med = {label: statistics.median(v) for label, v in ms.items()}
        out["groups"][str(g)] = {
            "kv_len": inputs[-1].tolist(), "ms": ms, "median_ms": med,
            "bound_ms": smoke.quant_work(*inputs)[0],
            "plans": {r: list(dk.split_plan(b, hq // g, t, device, r))
                      for r in ("gemv", "mma")}}
    crossover = 0
    for g in GROUPS:
        med = out["groups"][str(g)]["median_ms"]
        if med["gemv"] >= med["mma"]:
            break
        crossover = g
    out["largest_group_gemv_faster"] = crossover
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
    ap.add_argument("--route", choices=dk.QUANT_ROUTES, default="mma",
                    help='"gemv" only with --int8')
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
    if args.route == "gemv" and not args.int8:
        print("decode_splits: route gemv is the int8 cache's", file=sys.stderr)
        return 2
    if args.int8:
        res.update({name: [int8_times(shape, gen, device, args.reps,
                                      args.route, run)
                           for _ in range(args.draws)]
                    for name, shape, run in (
                        ("qwen", smoke.FULL.decode_qwen_int8, None),
                        ("qwen_seq_rank",
                         smoke.FULL.decode_qwen_int8_seq_rank, (2, 4)))})
        if args.route == "gemv":
            res["by_group"] = group_times(gen, device, args.reps)
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

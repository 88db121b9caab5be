#!/usr/bin/env python3
"""One model's decode step (or prefill) on one GPU, for comparing two trees
in one call.

    python3 tools/decode_step_ab.py --root DIR [--arch recurrentgemma-2b]
        [--prefill N] [--layers N]

Imports ``chip_smoke.py`` and ``repro_torch`` from the checkout at
``--root`` (this tree, or a ``git archive`` of another commit unpacked
where ``.gitignore`` lists it), builds its kernels, and times a decode step
of all 8 slots of ``--arch`` at full width and depth in bf16 (random
weights from ``--seed``): a cache of random keys and values filled, as a
prefill leaves it, to lengths spread over [100, 2600] (past a hybrid's
window of 2048).  Prints one JSON line: the step by CUDA events (the host's
issue included, median of ``--steps``), its device time and largest
kernels by ``torch.profiler``, and the hand-written kernels' launches a
step.  ``--prefill N`` times a batch-1 prefill of N random tokens instead
(a fresh state each call), as the serving engine runs one.  ``--layers
N`` cuts the depth (qwen1.5-32b's 64 layers do not fit the card with
``chip_smoke.py``'s checks; it serves 32); an int8 cache (``kv_quant``) is
filled with random entries in [-127, 127] and scales of about 2.5 / 127,
as normal keys and values quantize.  Run it for two roots in turns (A, B,
B, A) in one call: only there are the two comparable.  Needs one CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

import torch


def fill_state(state: dict, cfg, lens: torch.Tensor, gen) -> None:
    """Random keys and values for the first ``lens[r]`` positions of each
    row, and the positions, where a prefill of that length leaves them."""
    slots = lens.shape[0]
    if cfg.family == "hybrid":
        win = cfg.window or 2048
        for name in ("attn_k", "attn_v"):
            state[name].normal_(0.0, 0.5, generator=gen)
        for r in range(slots):
            n = int(lens[r])
            first = max(0, n - win)
            pos = torch.arange(first, n, dtype=torch.int32,
                               device=lens.device)
            state["slot_pos"][:, r, pos % win] = pos
    elif "k_q" in state:
        for name in ("k_q", "v_q"):
            state[name].copy_(torch.randint(
                -127, 128, state[name].shape, generator=gen,
                device=lens.device, dtype=torch.int8))
        for name in ("k_s", "v_s"):
            state[name].uniform_(2.0 / 127, 3.0 / 127, generator=gen)
    else:
        for name in ("k", "v"):
            for layer in state[name]:
                layer.normal_(0.0, 0.5, generator=gen)
    state["pos"].copy_(lens)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--arch", default="recurrentgemma-2b")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--prefill", type=int, default=0,
                    help="time a prefill of this many tokens instead")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path[:0] = [os.path.join(root, "src"), root]
    import chip_smoke as smoke
    from repro_torch.configs import get_config
    from repro_torch.models import api as model_api

    if not torch.cuda.is_available():
        print("decode_step_ab: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    cfg = get_config(args.arch)
    if args.layers:
        cfg = cfg.scaled(n_layers=args.layers)
    params = model_api.init_params(gen, cfg, device)
    if args.prefill:
        n = args.prefill
        toks = torch.randint(0, cfg.vocab, (1, n), generator=gen,
                             device=device, dtype=torch.int32)
        what = {"prefill_tokens": n}

        @torch.no_grad()
        def step():
            return model_api.prefill(
                params, {"tokens": toks}, cfg,
                model_api.init_decode_state(cfg, 1, n, device))
    else:
        slots, max_len = 8, 2600 + 8
        state = model_api.init_decode_state(cfg, slots, max_len, device)
        lens = torch.linspace(100, 2600, slots, device=device).round().int()
        fill_state(state, cfg, lens, gen)
        tok = torch.randint(0, cfg.vocab, (slots, 1), generator=gen,
                            device=device, dtype=torch.int32)
        what = {"kv_len": lens.tolist()}

        @torch.no_grad()
        def step():
            return model_api.decode_step(params, tok, cfg, state)

    step()
    smoke.sync(device)
    before = {name: w.launches for name, w in smoke.WRAPPERS.items()}
    step()
    launches = {name: w.launches - before[name]
                for name, w in smoke.WRAPPERS.items()
                if w.launches != before[name]}
    wall = [smoke.time_ms(step, device, 1, warmup=False)
            for _ in range(args.steps)]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            step()
        smoke.sync(device)
    print(json.dumps({
        "root": args.root, "arch": cfg.name, "n_layers": cfg.n_layers,
        **what,
        "step_ms_median": statistics.median(wall), "step_ms": wall,
        "kernel_launches_a_step": launches,
        **smoke.device_breakdown(prof, 3, top=12)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Serving driver: batched requests through the ServeEngine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \\
        --smoke --requests 8 --prompt-len 32 --max-new 16

runs on the GPU; ``--device cpu`` is the only way to run it on the CPU.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.serve.engine import Request, ServeEngine


def run_serving(
    arch: str,
    *,
    smoke: bool = True,
    requests: int = 8,
    prompt_len: int = 32,
    max_new: int = 16,
    slots: int = 4,
    seed: int = 0,
    device: torch.device | str | None = None,
) -> dict:
    """Random parameters from ``seed`` and ``requests`` random prompts
    through the engine on ``device`` (None: the GPU)."""
    device = resolve_device(device)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_params(gen, cfg, device)
    max_len = prompt_len + max_new + 8
    engine = ServeEngine(params, cfg, slots=slots, max_len=max_len,
                         seed=seed, device=device)
    rng = np.random.default_rng(seed)
    t0 = time.time()
    for rid in range(requests):
        engine.submit(Request(
            rid=rid,
            prompt=rng.integers(0, cfg.vocab, prompt_len).astype(np.int32),
            max_new_tokens=max_new,
        ))
    done = engine.run()
    dt = time.time() - t0
    return {
        "arch": cfg.name,
        "completed": len(done),
        "decode_tokens": engine.stats["decode_tokens"],
        "prefill_tokens": engine.stats["prefill_tokens"],
        "wall_s": round(dt, 3),
        "tokens_per_s": round(
            (engine.stats["decode_tokens"] + engine.stats["prefill_tokens"])
            / max(dt, 1e-9), 1,
        ),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' to run on "
                         "the CPU)")
    args = ap.parse_args(argv)
    print(json.dumps(run_serving(
        args.arch, smoke=args.smoke, requests=args.requests,
        prompt_len=args.prompt_len, max_new=args.max_new, slots=args.slots,
        seed=args.seed, device=args.device,
    ), indent=2))


if __name__ == "__main__":
    main()

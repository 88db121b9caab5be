"""Batched LM serving with continuous batching.

Spins up the ServeEngine on a smoke-scale model with random parameters,
submits a wave of requests with mixed lengths, and reports throughput and
per-request outputs.  Runs on the GPU; ``--device cpu`` runs it on the CPU.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_lm [--arch gemma-2b]
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.serve.engine import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b", choices=ARCHS)
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch)
    params = init_params(torch.Generator(device=device).manual_seed(0), cfg,
                         device)
    engine = ServeEngine(params, cfg, slots=args.slots, max_len=128,
                         device=device)
    rng = np.random.default_rng(0)

    t0 = time.perf_counter()
    for rid in range(args.requests):
        plen = int(rng.integers(8, 32))
        engine.submit(Request(
            rid=rid,
            prompt=rng.integers(0, cfg.vocab, plen).astype(np.int32),
            max_new_tokens=int(rng.integers(4, 16)),
            temperature=0.0 if rid % 2 == 0 else 0.8,
        ))
    done = engine.run()
    dt = time.perf_counter() - t0

    for r in sorted(done, key=lambda r: r.rid):
        print(f"req {r.rid}: prompt_len={len(r.prompt)} "
              f"generated={len(r.output)} tokens={r.output[:8]}...")
    total = engine.stats["decode_tokens"] + engine.stats["prefill_tokens"]
    print(f"\n{len(done)}/{args.requests} requests in {dt:.2f}s "
          f"({total / dt:.1f} tok/s incl. prefill; "
          f"{engine.stats['decode_tokens'] / dt:.1f} decode tok/s)")


if __name__ == "__main__":
    main()

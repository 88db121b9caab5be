#!/usr/bin/env python3
"""The distribution phase of ``chip_smoke.py`` alone.

    python3 tools/dist_probe.py [--seed 0] [--rehearse]

Needs one GPU (``--rehearse``: the CPU at toy sizes, measuring nothing).
Prints the ``env`` and ``build`` phases' lines (the ranks load the library
the build makes), then the ``dist`` phase's: 4 ranks on the card under
gloo run the collectives against one process and flash-decode over a
cache split in 4, one rank runs the NCCL path, gemma-2b's data-parallel
step runs at full width and 2 layers (ZeRO-1 against one rank in f32,
ZeRO-1 and replicated in bf16), and its ZeRO-1 checkpoint is restored onto
2 ranks and 1; then the card's name and power limit.  About four minutes,
the build included.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

from chip_smoke import (  # noqa: E402
    FULL,
    TOY,
    phase_build,
    phase_dist,
    phase_env,
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rehearse", action="store_true")
    args = ap.parse_args(argv)
    if args.rehearse:
        device, sizes = torch.device("cpu"), TOY
    elif not torch.cuda.is_available():
        print("dist_probe: no CUDA device: this run needs one GPU",
              file=sys.stderr)
        return 1
    else:
        device, sizes = torch.device("cuda", 0), FULL
    env = phase_env(device)
    phase_build(device)
    phase_dist(sizes, device, args.seed)
    if device.type == "cuda":
        print(env["card"], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""The single-card ``serve`` phases of ``chip_smoke.py`` alone.

    python3 tools/serve_probe.py [--seed 0] [--rehearse] [--kernels]
        [--archs qwen1.5-32b,internvl2-26b,stablelm-3b]

Needs one GPU (``--rehearse``: the CPU at toy sizes, measuring nothing).
Prints the ``env`` and ``build`` phases' lines, with ``--kernels`` the
``kernels`` phase's (every kernel held against its plain version and
timed, the served models' attention shapes among them), then one
``serve`` phase's line for each arch named (default: every arch of
``SERVE_ARCHS``): the model at full width in bf16 (qwen1.5-32b at the
depth of ``SERVE_DEPTH``), every kernel call of a check prefill and decode
step held against its plain version, the f32 check at ``F32_LAYERS``, the
profile, and the engine over the seeded traffic with the launch counters
read around it; then the card's name and power limit.
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
    SERVE_ARCHS,
    TOY,
    phase_build,
    phase_env,
    phase_kernels,
    phase_serve,
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rehearse", action="store_true")
    ap.add_argument("--kernels", action="store_true",
                    help="run the kernels phase after the build")
    ap.add_argument("--archs", default=",".join(SERVE_ARCHS),
                    help="comma-separated archs to serve (default: the "
                         "serve phases' every arch)")
    args = ap.parse_args(argv)
    archs = args.archs.split(",")
    unknown = set(archs) - set(SERVE_ARCHS)
    if unknown:
        ap.error(f"not served by chip_smoke.py: {sorted(unknown)}")
    if args.rehearse:
        device, sizes = torch.device("cpu"), TOY
    elif not torch.cuda.is_available():
        print("serve_probe: no CUDA device: this run needs one GPU",
              file=sys.stderr)
        return 1
    else:
        device, sizes = torch.device("cuda", 0), FULL
    env = phase_env(device)
    build = phase_build(device)
    if args.kernels:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        phase_kernels(sizes, device, gen, build)
    for arch in archs:
        phase_serve(sizes, device, args.seed, arch)
    if device.type == "cuda":
        print(env["card"], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

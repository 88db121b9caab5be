#!/usr/bin/env python3
"""The tensor-parallel and dry-run phases of ``chip_smoke.py`` alone.

    python3 tools/tp_probe.py [--seed 0] [--rehearse] [--kernels]
        [--archs rwkv6-3b,whisper-medium] [--no-dryrun] [--seq]
        [--seq-archs recurrentgemma-2b]

Needs one GPU (``--rehearse``: the CPU at toy sizes, measuring nothing).
Prints the ``env`` and ``build`` phases' lines (the ranks load the library
the build makes), with ``--kernels`` the ``kernels`` phase's (every
kernel held against its plain version and timed, the tensor-parallel
ranks' attention shapes among them), then the ``train`` phase's (whose
step the dry run's roofline is set beside), then the ``tp`` phase's: 4
ranks on the card under gloo over a (1, 4) ``("data", "model")`` mesh
serve phi3-mini-3.8b and granite-moe-3b-a800m at full width and depth in
bf16 (each rank's flash and decode attention on its heads, held against
the plain version; the engine's sampled tokens equal on every rank), hold
their f32 logits at two layers against one rank's, train gemma-2b and
granite-moe-1b-a400m at full width and depth (step 1's loss against one
card's), and at two layers hold the f32 step leaf by leaf against one
rank's, take a ZeRO-1 step over (2, 2) and restore its checkpoint onto
(1, 4) and one rank bit for bit; rwkv6-3b, recurrentgemma-2b and
whisper-medium are served and trained the same way; then the ``dryrun``
phase's (every cell of one pod on the meta device, checked against the
``tp`` and ``train`` phases); then the card's name and power limit.
``--archs`` serves and trains only the archs named (of the phase's);
``--no-dryrun`` leaves out the ``train`` and ``dryrun`` phases.  The tp
phase ends with its cells over other meshes (``TP_SEQ_CELLS``): gemma-2b
over (1, 4) with its decode cache split by sequence (``shard_seq``),
phi3-mini-3.8b over (2, 2) with its slots split over the data ranks,
recurrentgemma-2b over (1, 4) with its ring split by sequence.
``--seq`` runs those cells alone (no other arch served or trained, no
``train`` phase), then their dry cells on the meta device held against
them exactly (a rank's bytes; the decode step's collective spans);
``--seq-archs`` keeps only the cells of the archs named.
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
    TP_SEQ_CELLS,
    TP_SERVE_ARCHS,
    TP_TRAIN_ARCHS,
    dry_cell,
    emit,
    phase_build,
    phase_dryrun,
    phase_env,
    phase_kernels,
    phase_tp,
    phase_train,
    seq_dry_cells,
    seq_dry_checks,
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rehearse", action="store_true")
    ap.add_argument("--kernels", action="store_true",
                    help="run the kernels phase after the build")
    ap.add_argument("--archs", default=None,
                    help="comma-separated archs to serve and train over "
                         "the ranks (default: the tp phase's)")
    ap.add_argument("--no-dryrun", action="store_true",
                    help="leave out the train and dryrun phases")
    ap.add_argument("--seq", action="store_true",
                    help="only the tp phase's cells over other meshes "
                         "(gemma-2b's cache split by sequence, phi3-mini "
                         "over (2, 2), recurrentgemma-2b's ring split by "
                         "sequence) and their dry cells")
    ap.add_argument("--seq-archs", default=None,
                    help="comma-separated: only the cells over other "
                         "meshes of these archs")
    args = ap.parse_args(argv)
    seq_cells = tuple(c for c in TP_SEQ_CELLS if args.seq_archs is None
                      or c[0] in args.seq_archs.split(","))
    archs = args.archs.split(",") if args.archs else None
    if args.seq:
        archs = []
    serve_archs = tuple(a for a in TP_SERVE_ARCHS
                        if archs is None or a in archs)
    train_archs = tuple(a for a in TP_TRAIN_ARCHS
                        if archs is None or a in archs)
    if args.rehearse:
        device, sizes = torch.device("cpu"), TOY
    elif not torch.cuda.is_available():
        print("tp_probe: no CUDA device: this run needs one GPU",
              file=sys.stderr)
        return 1
    else:
        device, sizes = torch.device("cuda", 0), FULL
    env = phase_env(device)
    build = phase_build(device)
    if args.kernels:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        phase_kernels(sizes, device, gen, build)
    train = None if args.no_dryrun or args.seq else phase_train(
        sizes, device, args.seed)
    tp = phase_tp(sizes, device, args.seed, serve_archs, train_archs,
                  seq_cells)
    if train is not None:
        phase_dryrun(sizes, tp, train)
    elif args.seq:
        metrics = {k: dry_cell(*a)
                   for k, a in seq_dry_cells(sizes, seq_cells).items()}
        emit({"phase": "dryrun_seq",
              "tp_seq": seq_dry_checks(tp["seq"], metrics)})
    if device.type == "cuda":
        print(env["card"], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

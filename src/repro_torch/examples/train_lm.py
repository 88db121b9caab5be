"""End-to-end LM training driver: the ~100M-parameter run.

Trains a gemma-family model on the synthetic token stream with the whole
substrate: data pipeline, AdamW with the cosine schedule, checkpointing,
fault supervision.  The default is a quick run of gemma-2b's smoke config;
``--full`` trains a ~100M-parameter model (12 layers, d_model 768, d_ff
3072, a 32k vocab) for a few hundred steps.  It runs on the GPU;
``--device cpu`` runs it on the CPU.

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--full] [--steps N]
"""

from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs import get_config
from repro_torch.launch.train import run_training


def config_100m():
    """gemma-2b cut to ~100M parameters, in f32 without remat."""
    return get_config("gemma-2b").scaled(
        name="gemma-100m", n_layers=12, d_model=768, n_heads=12,
        n_kv_heads=4, head_dim=64, d_ff=3072, vocab=32_768,
        dtype="float32", remat=False,
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="~100M params, a few hundred steps")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "lightning_lm_ckpt"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' to run on "
                         "the CPU)")
    args = ap.parse_args(argv)

    if args.full:
        result = run_training(
            "gemma-2b", cfg=config_100m(),
            steps=args.steps or 300, batch=8, seq=512,
            ckpt_dir=args.ckpt_dir, ckpt_every=50, log_every=10,
            device=args.device,
        )
    else:
        result = run_training(
            "gemma-2b", smoke=True,
            steps=args.steps or 100, batch=8, seq=128,
            ckpt_dir=args.ckpt_dir, ckpt_every=25, log_every=10,
            device=args.device,
        )

    print(f"\narch={result['arch']}  steps={result['steps']}")
    print(f"loss: {result['first_loss']:.4f} -> {result['last_loss']:.4f}")
    if not result["last_loss"] < result["first_loss"]:
        raise SystemExit("training must learn: the loss did not fall")


if __name__ == "__main__":
    main()

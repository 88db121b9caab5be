"""Learning-rate schedules."""

from __future__ import annotations

import math

import torch


def cosine_with_warmup(
    step,
    *,
    peak_lr: float = 3e-4,
    warmup_steps: int = 100,
    total_steps: int = 10_000,
    min_ratio: float = 0.1,
):
    """Linear warm-up to ``peak_lr``, then a cosine down to
    ``min_ratio * peak_lr`` at ``total_steps``.  A Python float for an int
    ``step``; a 0-d float32 tensor on ``step``'s device for a tensor
    ``step`` (the train step's, so that reading the rate never waits for the
    device), computed in float32 as the reference computes it."""
    if not isinstance(step, torch.Tensor):
        warm = step / max(1.0, warmup_steps)
        frac = (step - warmup_steps) / max(1.0, total_steps - warmup_steps)
        frac = min(max(frac, 0.0), 1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (
            1 + math.cos(math.pi * frac))
        return peak_lr * (warm if step < warmup_steps else cos)
    step = step.to(torch.float32)
    warm = step / max(1.0, warmup_steps)
    frac = (step - warmup_steps) / max(1.0, total_steps - warmup_steps)
    frac = frac.clamp(0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * frac))
    return peak_lr * torch.where(step < warmup_steps, warm, cos)

"""Gradient compression for the cross-network all-reduce: int8 with error
feedback.

At multi-pod scale the gradient all-reduce crosses the data-center network
once a step; int8 quantization cuts those bytes 4x against f32 (2x against
bf16).  Error feedback (the 1-bit SGD lineage, Seide et al.) keeps the
quantization residual locally and adds it back the next step, which
preserves convergence.  The collective over the quantized payload
(the reference's ``compressed_psum``) waits for the port's ranks, ROADMAP
Queue A item 10.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .adamw import _map


def compress_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8; returns (q, scale), the scale a 0-d f32
    tensor (rounding half to even, as the reference's ``jnp.round``)."""
    x = x.to(torch.float32)
    scale = torch.clamp(x.abs().max() / 127.0, min=1e-12)
    q = torch.clamp(torch.round(x / scale), -127, 127)
    return q.to(torch.int8), scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


@dataclasses.dataclass
class ErrorFeedback:
    """Residual accumulator with the structure of the gradients."""

    residual: Any

    @staticmethod
    def init(grads: Any) -> "ErrorFeedback":
        return ErrorFeedback(_map(
            lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                  device=g.device), grads))

"""Gradient compression for the cross-network all-reduce: int8 with error
feedback.

At multi-pod scale the gradient all-reduce crosses the data-center network
once a step; int8 quantization cuts those bytes 4x against f32 (2x against
bf16).  Error feedback (the 1-bit SGD lineage, Seide et al.) keeps the
quantization residual locally and adds it back the next step, which
preserves convergence.  ``compressed_psum`` is the collective: a psum in
int32 over the quantized payload, after a pmax that gives every rank the
same scale.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.dist import ranks

from .adamw import _leaves, _map, _rebuild


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


def compressed_psum(
    grads: Any,
    axis_name: str | tuple[str, ...],
    ef: ErrorFeedback | None = None,
) -> tuple[Any, ErrorFeedback | None]:
    """int8-quantized psum with error feedback, leaf by leaf, called by
    every rank along ``axis_name``.

    Each leaf is quantized (after adding this rank's residual), psum'd in
    int32 (exact: no quantization error accumulates in the reduction),
    dequantized with the ranks' largest scale, and this rank's
    quantization error is carried to the next step in the returned
    ``ErrorFeedback`` (None where ``ef`` is None)."""

    def one(g, r):
        gf = g.to(torch.float32) + (r if r is not None else 0.0)
        _, scale = compress_int8(gf)
        # All ranks must agree on the scale: use the max.
        scale = ranks.pmax(scale.reshape(1), axis_name).reshape(())
        q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int32)
        total = ranks.psum(q, axis_name)
        out = total.to(torch.float32) * scale
        new_r = gf - q.to(torch.float32) * scale
        return out.to(g.dtype), new_r

    flat_g = _leaves(grads)
    flat_r = _leaves(ef.residual) if ef is not None else [None] * len(flat_g)
    outs, new_rs = [], []
    for g, r in zip(flat_g, flat_r, strict=True):
        o, nr = one(g, r)
        outs.append(o)
        new_rs.append(nr)
    new_ef = ErrorFeedback(_rebuild(ef.residual, new_rs)) \
        if ef is not None else None
    return _rebuild(grads, outs), new_ef

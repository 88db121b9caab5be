"""Reduction support for ``reduce(f)`` annotations (paper §2.3–2.4).

Lightning allocates temporary memory for block-level partials and then
performs a multi-level reduction: superblock → device → node → global.
This module holds the per-op combining functions used by the single-device
launch path; the cross-worker collective arrives with multi-worker
execution.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch


def _extreme(dtype: torch.dtype, largest: bool) -> torch.Tensor:
    info = torch.finfo(dtype) if dtype.is_floating_point \
        else torch.iinfo(dtype)
    return torch.tensor(info.max if largest else info.min, dtype=dtype)


#: op string → (combining fn, identity element factory)
REDUCE_FNS: dict[str, tuple[Callable, Callable]] = {
    "+": (torch.add, lambda dtype: torch.zeros((), dtype=dtype)),
    "*": (torch.mul, lambda dtype: torch.ones((), dtype=dtype)),
    "min": (torch.minimum, lambda dtype: _extreme(dtype, True)),
    "max": (torch.maximum, lambda dtype: _extreme(dtype, False)),
}


def identity_for(op: str, dtype: torch.dtype) -> torch.Tensor:
    _, ident = REDUCE_FNS[op]
    return ident(dtype)


def combine(op: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    fn, _ = REDUCE_FNS[op]
    return fn(a, b)


def reduce_stack(op: str, parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Reduce a list of equally-shaped partials (single-device path)."""
    fn, _ = REDUCE_FNS[op]
    out = parts[0]
    for p in parts[1:]:
        out = fn(out, p)
    return out

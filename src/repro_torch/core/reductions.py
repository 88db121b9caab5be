"""Reduction support for ``reduce(f)`` annotations (paper §2.3–2.4).

Lightning allocates temporary memory for block-level partials and then
performs a multi-level reduction: superblock → device → node → global.
This module holds the per-op combining functions (single-device path), the
combine across a mesh's workers on one controller (``collective_reduce``)
and its rank form, run by every rank of a rank mesh
(``collective_reduce_ranks``).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from repro_torch.dist import ranks


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


def collective_reduce(op: str, partials: Sequence[torch.Tensor],
                      axis_names=()) -> torch.Tensor:
    """Combine the workers' partials (by flat worker index) over the mesh
    axes ``axis_names``, on the first partial's device.  ``+``, ``min`` and
    ``max`` fold them in worker order; ``*`` is the product of the gathered
    partials, as the reference takes it (``all_gather`` then ``prod``: the
    TPU has no product collective); any other op raises.  With no axes,
    nothing is combined: the first worker's partial, as the reference's
    replicated output takes worker 0's."""
    if isinstance(axis_names, str):
        axis_names = (axis_names,)
    if op not in REDUCE_FNS:
        raise ValueError(f"unsupported reduce op {op!r}")
    first = partials[0]
    if not tuple(axis_names):
        return first
    parts = [p.to(first.device) for p in partials]
    if op == "*":
        return torch.prod(torch.stack(parts), dim=0, dtype=first.dtype)
    return reduce_stack(op, parts)


def collective_reduce_ranks(op: str, x: torch.Tensor,
                            axis_names=()) -> torch.Tensor:
    """The reference's ``collective_reduce`` over ranks: every rank of the
    current rank mesh (``ranks.use_mesh``) calls it with its own partial
    ``x`` and gets the combined result.  ``+`` is ``ranks.psum``, ``min``
    ``ranks.pmin``, ``max`` ``ranks.pmax``; ``*`` gathers the partials and
    takes their product in index order (gloo and NCCL have a product
    all-reduce, but the reference's gather keeps one order on every
    rank); any other op raises.  With no axes, ``x`` itself."""
    if isinstance(axis_names, str):
        axis_names = (axis_names,)
    axis_names = tuple(axis_names)
    if op not in REDUCE_FNS:
        raise ValueError(f"unsupported reduce op {op!r}")
    if not axis_names:
        return x
    if op == "*":
        return torch.prod(ranks.all_gather(x, axis_names), dim=0,
                          dtype=x.dtype)
    return {"+": ranks.psum, "min": ranks.pmin,
            "max": ranks.pmax}[op](x, axis_names)

"""Collectives over named mesh axes of ranks.

The distribution layer's compute/communication-overlap primitives (paper
section 4.2: Lightning overlaps chunk transfers with kernel execution;
here the same idea applied to the collectives the sharding rules imply),
each called by every rank of the axis, as the reference's run inside
``shard_map``:

* :func:`ring_allreduce`: an all-reduce built from ``ppermute`` hops, the
  bandwidth-optimal reduce-scatter plus all-gather when the leading dim
  divides the ring, else the rotate-and-accumulate ring;
* :func:`ring_allgather_matmul`: collective matmul for contraction-sharded
  operands, each rank's rank-``k/n`` partial product combined by the ring;
* :func:`hierarchical_grad_allreduce`: reduce over the fast intra-pod axes
  first and only then over the slow cross-pod axes.

Every hop and reduction goes through :mod:`repro_torch.dist.ranks`.  Each
collective runs eagerly and returns when its result is in place, so its
span (``set_tracer``) covers the time it took on the host.
"""

from __future__ import annotations

import math
from typing import Any, Sequence

import torch

from repro_torch.obs.trace import NULL_TRACER

from . import ranks

# Module-level tracer hook: ``set_tracer(tracer)`` makes every collective
# emit a span on stream "dist", on the same timeline as the simulator's
# and the serve engine's.  The default NULL_TRACER costs nothing.
_TRACER = NULL_TRACER


def set_tracer(tracer) -> object:
    """Install a :class:`repro_torch.obs.trace.Tracer` for collective
    spans; returns the previous tracer so callers can restore it."""
    global _TRACER
    prev = _TRACER
    _TRACER = tracer if tracer is not None else NULL_TRACER
    return prev


def _span(name: str, **args):
    return _TRACER.span(name, worker=0, stream="dist", cat="dist", **args)


def _leaves(tree: Any) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _map(fn, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def ring_allreduce(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """Ring all-reduce built from ``ppermute`` hops.

    The reduce-scatter plus all-gather schedule when the leading dim
    divides the ring size, otherwise the rotate-and-accumulate ring (n-1
    hops of the full tensor)."""
    n = ranks.axis_size(axis_name)
    with _span("collective:ring_allreduce", axis=axis_name, n=n,
               size=int(math.prod(x.shape))):
        if n == 1:
            return x
        if x.ndim >= 1 and x.shape[0] % n == 0:
            return _ring_allreduce_two_phase(x, axis_name, n)
        return _ring_allreduce_rotate(x, axis_name, n)


def _ring_perm(n: int) -> list[tuple[int, int]]:
    return [(i, (i + 1) % n) for i in range(n)]


def _ring_allreduce_rotate(x: torch.Tensor, axis_name: str,
                           n: int) -> torch.Tensor:
    perm = _ring_perm(n)
    acc = x
    send = x
    for _ in range(n - 1):
        send = ranks.ppermute(send, axis_name, perm)
        acc = acc + send
    return acc


def _ring_allreduce_two_phase(x: torch.Tensor, axis_name: str,
                              n: int) -> torch.Tensor:
    """Reduce-scatter ring then all-gather: 2(n-1) hops of 1/n the bytes."""
    perm = _ring_perm(n)
    idx = ranks.axis_index(axis_name)
    chunks = x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))

    def chunk(i):
        return chunks[i % n]

    # Phase 1, reduce-scatter: at step s rank i forwards the running sum of
    # chunk (i - s) and folds its own copy of chunk (i - s - 1) into what
    # arrives; after n-1 steps it holds the whole sum of chunk (i + 1) % n.
    send = chunk(idx)
    for s in range(n - 1):
        recv = ranks.ppermute(send, axis_name, perm)
        send = recv + chunk(idx - s - 1)

    # Phase 2, all-gather the reduced chunks.  Rank j holds chunk
    # (j + 1) % n, so gathering by rank index needs a roll of 1 to restore
    # chunk order.
    parts = ranks.all_gather(send, axis_name)
    parts = torch.roll(parts, 1, dims=0)
    return parts.reshape(x.shape)


def ring_allgather_matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    axis_name: str,
    precision: Any = None,
) -> torch.Tensor:
    """Collective matmul for contraction-sharded operands.

    Each rank holds a column shard ``x[:, k_i]`` and the matching row shard
    ``w[k_i, :]``, so the local product is a full-shape partial, and the
    ring combines the ``n`` partials into ``x @ w`` on every rank.  The
    local product is ``torch.matmul`` (the reference's ``jnp.matmul``);
    ``precision`` is accepted for the reference's signature."""
    del precision
    with _span("collective:ring_allgather_matmul", axis=axis_name,
               m=int(x.shape[0]), k=int(x.shape[-1]), n=int(w.shape[-1])):
        partial = torch.matmul(x, w)
        return ring_allreduce(partial, axis_name)


def hierarchical_grad_allreduce(
    grads: Any,
    intra_axes: Sequence[str] = ("data",),
    inter_axes: Sequence[str] = ("pod",),
) -> Any:
    """Pod-then-data two-level gradient all-reduce over a tree (dicts,
    lists and tuples of tensors).

    Reduces over the fast ``intra_axes`` first and only then over
    ``inter_axes``, so the slow hop moves one already-reduced copy a pod.
    Equal to a flat ``psum`` over both up to the order of the adds; either
    group may be empty."""
    intra = tuple(intra_axes or ())
    inter = tuple(inter_axes or ())

    def reduce_leaf(v):
        if intra:
            v = ranks.psum(v, intra)
        if inter:
            v = ranks.psum(v, inter)
        return v

    with _span("collective:hierarchical_grad_allreduce",
               intra=",".join(intra), inter=",".join(inter),
               leaves=len(_leaves(grads))):
        return _map(reduce_leaf, grads)

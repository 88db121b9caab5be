"""Tensor-parallel (Megatron) operators over the ``"model"`` axis of ranks.

The reference splits heads, d_ff and vocab over ``"model"`` by GSPMD over
``tp_rules`` and lets XLA insert the collectives.  Here each rank holds its
slice of every split weight (``ranks.spec_slice`` under the rules' specs),
and the layers call these autograd ``Function``\\ s where GSPMD would put a
collective.  An activation that is not split is the same on every rank of
the axis, and so is its gradient:

* ``copy_to_model``: identity forward, psum of the gradient backward, in
  front of a column-split product (its input is used by every rank's
  slice);
* ``reduce_from_model``: psum forward, identity backward, after a
  row-split product (each rank holds a partial sum);
* ``gather_from_model(x, dim)``: the ranks' slices concatenated along
  ``dim`` forward; backward the rank's slice of the psum of the gradient (a
  reduce-scatter), as for keys and values whose head the axis does not
  split;
* ``vocab_parallel_embed``: the owning rank looks a token up, the others
  give zeros, then ``reduce_from_model``;
* ``vocab_parallel_xent``: cross-entropy on vocab-split logits; the max
  and the sum of exponentials are reduced over the axis and the gold logit
  comes from its owner, with a backward written by hand (softmax minus the
  one-hot target, local to each rank).

``ranks.psum_grad`` (psum forward *and* backward) is neither of the first
two: used in their place it multiplies gradients by the axis's size.

Each operator takes the mesh (None: the current one) and keeps it for its
backward, and each collective emits a ``collective:*`` span on the
``dist`` stream of ``collectives.set_tracer``'s tracer.
"""

from __future__ import annotations

import torch

from . import ranks
from .collectives import _span

#: the mesh axis the layers split over
MODEL = "model"


def _resolve(mesh):
    return ranks.current_mesh() if mesh is None else mesh


def _psum(x: torch.Tensor, mesh, axis: str, name: str) -> torch.Tensor:
    with ranks.use_mesh(mesh), _span(f"collective:{name}", axis=axis,
                                     bytes=x.numel() * x.element_size()):
        return ranks.psum(x.contiguous(), axis)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _psum(g, ctx.mesh, ctx.axis, "copy_to_model"), None, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _psum(x, mesh, axis, "reduce_from_model")

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh, axis):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        ctx.size = x.shape[dim]
        with ranks.use_mesh(mesh), _span(
                "collective:gather_from_model", axis=axis,
                bytes=x.numel() * x.element_size()):
            ctx.index = ranks.axis_index(axis)
            parts = ranks.all_gather(x.contiguous(), axis)
        return torch.cat(list(parts.unbind(0)), dim=dim)

    @staticmethod
    def backward(ctx, g):
        whole = _psum(g, ctx.mesh, ctx.axis, "gather_from_model_grad")
        part = whole.narrow(ctx.dim, ctx.index * ctx.size, ctx.size)
        return part.contiguous(), None, None, None


def copy_to_model(x: torch.Tensor, mesh=None,
                  axis: str = MODEL) -> torch.Tensor:
    """``x`` as it is; its gradient summed over ``axis``."""
    return _CopyToModel.apply(x, _resolve(mesh), axis)


def reduce_from_model(x: torch.Tensor, mesh=None,
                      axis: str = MODEL) -> torch.Tensor:
    """The sum of the ranks' ``x`` over ``axis``; the gradient passes as
    it is."""
    return _ReduceFromModel.apply(x, _resolve(mesh), axis)


def gather_from_model(x: torch.Tensor, dim: int, mesh=None,
                      axis: str = MODEL) -> torch.Tensor:
    """The ranks' ``x`` along ``axis`` concatenated in index order along
    ``dim``; the gradient is this rank's slice of its sum over ``axis``."""
    return _GatherFromModel.apply(x, dim % x.ndim, _resolve(mesh), axis)


def vocab_parallel_embed(table: torch.Tensor, tokens: torch.Tensor,
                         mesh=None, axis: str = MODEL) -> torch.Tensor:
    """Rows of an embedding whose vocab (axis 0) is split over ``axis``:
    ``table`` is this rank's slice, rows ``index * V_local`` on; a token
    another rank owns gives zeros here, and the sum over the ranks is every
    token's row (exact: one rank adds its row to zeros)."""
    mesh = _resolve(mesh)
    with ranks.use_mesh(mesh):
        lo = ranks.axis_index(axis) * table.shape[0]
    local = tokens.long() - lo
    mine = (local >= 0) & (local < table.shape[0])
    rows = table[local.clamp(0, table.shape[0] - 1)]
    rows = torch.where(mine[..., None], rows, torch.zeros_like(rows))
    return reduce_from_model(rows, mesh, axis)


class _VocabParallelXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, z_loss, mesh, axis):
        lf = logits.float()
        v = lf.shape[-1]
        with ranks.use_mesh(mesh), _span("collective:vocab_parallel_xent",
                                         axis=axis):
            lo = ranks.axis_index(axis) * v
            m = ranks.pmax(lf.amax(dim=-1).contiguous(), axis)
            e = torch.exp(lf - m[..., None])
            lse = m + torch.log(ranks.psum(e.sum(dim=-1), axis))
            local = labels.long() - lo
            mine = (local >= 0) & (local < v)
            idx = local.clamp(0, v - 1)
            gold = torch.gather(lf, -1, idx[..., None])[..., 0]
            gold = ranks.psum(torch.where(mine, gold, torch.zeros_like(gold)),
                              axis)
        loss = lse - gold
        if z_loss:
            loss = loss + z_loss * lse ** 2
        ctx.save_for_backward(e, m, lse, idx, mine)
        ctx.z_loss, ctx.dtype = z_loss, logits.dtype
        return loss

    @staticmethod
    def backward(ctx, g):
        e, m, lse, idx, mine = ctx.saved_tensors
        g = g.float()
        scale = g * (1.0 + 2.0 * ctx.z_loss * lse) if ctx.z_loss else g
        # softmax = exp(lf - m) / exp(lse - m)
        grad = e * (scale * torch.exp(m - lse))[..., None]
        gold = torch.where(mine, -g, torch.zeros_like(g))
        grad.scatter_add_(-1, idx[..., None], gold[..., None])
        return grad.to(ctx.dtype), None, None, None, None


def vocab_parallel_xent(logits: torch.Tensor, labels: torch.Tensor,
                        z_loss: float = 0.0, mesh=None,
                        axis: str = MODEL) -> torch.Tensor:
    """Each token's cross-entropy (f32, ``labels``' shape) from logits
    whose vocab (the last axis) is split over ``axis``, ``logits`` this
    rank's slice; the same on every rank.  ``z_loss`` adds
    ``z_loss * lse ** 2``, as ``models.layers.softmax_xent``."""
    return _VocabParallelXent.apply(logits, labels, float(z_loss),
                                    _resolve(mesh), axis)

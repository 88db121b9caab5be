"""AdamW with mixed precision, and the ZeRO-1 axes of its state.

Params are stored in the model dtype (bf16 at scale); the optimizer keeps
f32 master weights and first and second moments, 12 bytes a parameter
against the params' 2.  ``zero1_axes`` gives those leaves the logical axes
that shard them over the data axis as well as the model axis (ROADMAP Queue
``repro_torch.dist.sharding``'s rules map them onto ranks).

A parameter tree here is an ``nn.Module``, taken as its named parameters
(``dict(module.named_parameters())``: a tied weight once), or nested dicts
and lists of tensors.  The optimizer state mirrors the tree it was made
from.  The update goes leaf by leaf, so that the float32 copy of the
gradients exists for one leaf at a time: at gemma-2b's 2.5e9 parameters a
copy of all of them would be 10 GB.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping

import torch
import torch.nn as nn

from repro_torch.dist import ranks


#: elements of a leaf the update takes at a time: its f32 temporaries
#: (about five of them) are then 64 MiB each, where gemma-2b's embedding of
#: 5.2e8 parameters would need 2 GiB each
UPDATE_CHUNK = 1 << 24


@dataclasses.dataclass
class AdamWState:
    step: torch.Tensor  # () int32
    master: Any  # f32 copy of params
    mu: Any  # first moment (f32)
    nu: Any  # second moment (f32)

    # The reference's pytree plumbing, for code that walks a state
    # generically: (children, aux) and back.
    def tree_flatten(self):
        return (self.step, self.master, self.mu, self.nu), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


def _tree(params: Any) -> Any:
    """``params`` as this module walks it: a module as its named
    parameters."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return params


def _leaves(tree: Any) -> list[torch.Tensor]:
    if isinstance(tree, Mapping):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def _map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, Mapping):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _rebuild(tree: Any, leaves: list) -> Any:
    """``tree``'s structure with ``leaves`` in its leaves' order."""
    it = iter(leaves)
    return _map(lambda _: next(it), tree)


@torch.no_grad()
def adamw_init(params: Any) -> AdamWState:
    """Step 0, an f32 master copy of ``params`` and zero moments.  The
    master is a copy even of f32 params, as the reference's
    ``copy=True``: the in-place update writes the master and then the params,
    which must not be one buffer."""
    tree = _tree(params)
    leaves = _leaves(tree)
    device = leaves[0].device if leaves else torch.device("cpu")
    zeros = lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                  device=x.device)
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        master=_map(lambda x: x.detach().to(torch.float32, copy=True), tree),
        mu=_map(zeros, tree),
        nu=_map(zeros, tree),
    )


@torch.no_grad()
def global_norm(tree: Any, split: Any = None,
                axis: str = "model") -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares.

    ``split`` (names of a flat tree's leaves) are each this rank's slice of
    a leaf split over ``axis``: their squares are summed over the ranks of
    ``axis`` on the current mesh, and every other leaf, the same on each of
    those ranks, is counted once."""
    if not split:
        return torch.sqrt(sum(torch.sum(x.float() ** 2)
                              for x in _leaves(_tree(tree))))
    tree = _tree(tree)
    sq = lambda names: sum(torch.sum(tree[k].float() ** 2)  # noqa: E731
                           for k in names)
    parts = ranks.psum(sq([k for k in tree if k in split]).reshape(1),
                       axis).reshape(())
    return torch.sqrt(parts + sq([k for k in tree if k not in split]))


@torch.no_grad()
def adamw_update(
    grads: Any,
    state: AdamWState,
    lr: torch.Tensor | float,
    *,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    grad_clip: float = 1.0,
    param_dtype: torch.dtype = torch.bfloat16,
    out: Any = None,
    grad_norm: torch.Tensor | None = None,
) -> tuple[Any, AdamWState, dict]:
    """Returns (new model-dtype params, new state, metrics).

    The reference's steps in its order: the global norm of ``grads``, the
    clip scale ``min(1, grad_clip / max(norm, 1e-9))`` applied to the f32
    gradients before the moments, bias correction by ``1 - b**t`` with t
    the new step, and decoupled weight decay on the master.  Without
    ``out`` the given state is left as it is and every returned tensor is
    new.  With ``out`` (a params tree, as the train step passes its
    module) the update is made in place: the state's master and moments
    leaf by leaf, the new params into ``out``'s tensors (each cast from the
    master through ``param_dtype``, so that a leaf kept in f32 whatever the
    config holds the reference's rounded value), and the state returned is
    ``state`` with its step advanced.  ``grad_norm`` is the norm of the
    whole gradient where ``grads`` and the state are one rank's slice of
    theirs (ZeRO-1): the clip then scales every slice alike."""
    grads = _tree(grads)
    step = state.step + 1
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    t = step.to(torch.float32)
    mu_hat_scale = 1.0 / (1.0 - b1 ** t)
    nu_hat_scale = 1.0 / (1.0 - b2 ** t)

    targets = _leaves(_tree(out)) if out is not None else None
    masters, mus, nus, params = [], [], [], []
    for i, (g, p, m, v) in enumerate(zip(
            _leaves(grads), _leaves(state.master), _leaves(state.mu),
            _leaves(state.nu), strict=True)):
        if out is None:
            p, m, v = p.clone(), m.clone(), v.clone()
            target = torch.empty(p.shape, dtype=param_dtype, device=p.device)
        else:
            target = targets[i]
        for x in (p, m, v, target):
            if not x.is_contiguous():
                raise ValueError("AdamW updates its state and params in "
                                 "place: they must be contiguous")
        flat = [x.reshape(-1) for x in (g, p, m, v, target)]
        # A chunk of a leaf at a time, so that the f32 temporaries stay
        # small beside the leaf; every element's arithmetic is the same.
        for lo in range(0, p.numel(), UPDATE_CHUNK):
            gc, pc, mc, vc, tc = (x[lo:lo + UPDATE_CHUNK] for x in flat)
            gc = gc.to(torch.float32) * scale
            mc.mul_(b1).add_(gc * (1 - b1))
            vc.mul_(b2).add_(gc * (1 - b2) * gc)
            del gc
            u = (mc * mu_hat_scale) / (vc * nu_hat_scale).sqrt_().add_(eps)
            pc.sub_(u.add_(pc * weight_decay).mul_(lr))
            del u
            tc.copy_(pc.to(param_dtype))
        if out is None:
            params.append(target)
        masters.append(p)
        mus.append(m)
        nus.append(v)

    metrics = {"grad_norm": gnorm, "lr": torch.as_tensor(lr)}
    if out is not None:
        state.step = step
        return out, state, metrics
    new_state = AdamWState(step=step,
                           master=_rebuild(state.master, masters),
                           mu=_rebuild(state.mu, mus),
                           nu=_rebuild(state.nu, nus))
    return _rebuild(grads, params), new_state, metrics


def _is_axes(x: Any) -> bool:
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None)))
                                        for a in x)


def zero1_axes(param_logical_axes: Any, shard_axis: str = "data") -> Any:
    """ZeRO-1 logical axes for optimizer-state leaves.

    The f32 master and two moments are 12 bytes a parameter, 6x the bf16
    params, so they shard over the model axis (inherited from the param's
    own layout) and the data axis.  Every 2-D+ weight has its ``d_model``
    axis relabelled ``zero1`` (which the rules map to the data axes); a
    1-D leaf without one (a norm scale, a bias) whose axis is otherwise
    unsharded becomes ``("zero1",)``.  A tuple of axis names (str or None)
    is a leaf; dicts and lists are walked."""

    def refine(axes):
        if not axes:
            return axes
        out = list(axes)
        for i, a in enumerate(out):
            if a == "d_model":
                out[i] = "zero1"
                return tuple(out)
        if len(out) == 1 and out[0] is None:
            return ("zero1",)
        return tuple(out)

    def walk(tree):
        if _is_axes(tree):
            return refine(tree)
        if isinstance(tree, Mapping):
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v) for v in tree)
        return tree

    return walk(param_logical_axes)

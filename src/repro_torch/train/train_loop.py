"""Train-step factory: loss -> gradients -> (reduction over ranks) -> AdamW,
with microbatch gradient accumulation and the reference's buffer donation
as in-place updates.

The step runs eagerly, through the models' plain attention and scans
(``attention_impl`` "xla", the reference's default and the path it trains
through): the hand-written kernels are forward-only, as the reference's
Pallas kernels are, so ``make_train_step`` refuses a config that names
them.

Given ``rules`` and a ``mesh`` of ranks (``repro_torch.launch.mesh``), the
step is data-parallel, the port's counterpart of the reference's GSPMD step
on the same global batch: each rank takes its rows of the global batch,
computes its gradients, and the ranks all-reduce them
(``hierarchical_grad_allreduce``: over the batch axes within a pod, then
over ``"pod"``) and scale them by one over the ranks.  Two flavors, as the
reference's:

* ``dp_rules``: every rank keeps the whole optimizer state and updates it;
* ``tp_rules`` (``zero1``): the f32 master and moments are sharded along
  each leaf's ``zero1`` axis over the data axes; each rank updates its
  slice (the clip taken from the norm of the whole gradient, the same on
  every rank) and the new params are all-gathered.

On a ``"model"`` axis of more than one rank (every family) the params are
split by their specs as well: each rank holds its slice of every leaf the rules
split over ``"model"`` and runs the tensor-parallel layers
(:mod:`repro_torch.dist.tensor_parallel`).  The gradients of those leaves
are the rank's own; a replicated leaf (a norm's scale) gets the same
gradient on every rank of the axis and is not reduced over it.  The
gradients are all-reduced over the batch axes only, the clip's norm sums
the split leaves' squares over ``"model"`` and counts a replicated leaf
once, and ZeRO-1 slices and gathers a leaf over the data axes only.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import math
from typing import Any, Callable

import torch
import torch.nn as nn

from repro_torch.dist import ranks
from repro_torch.dist.collectives import hierarchical_grad_allreduce
from repro_torch.dist.sharding import (
    ShardingRules,
    batch_axes,
    batch_ranks,
    model_ranks,
    tree_specs,
)
from repro_torch.models import api as model_api
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw_init, adamw_update, cosine_with_warmup
from repro_torch.optim.adamw import AdamWState, global_norm, zero1_axes


@dataclasses.dataclass
class TrainState:
    params: nn.Module
    opt: AdamWState

    @property
    def step(self) -> torch.Tensor:
        return self.opt.step


def init_train_state(generator: torch.Generator, cfg: ModelConfig,
                     device: torch.device | str | None = None,
                     rules: ShardingRules | None = None) -> TrainState:
    """Random parameters from ``generator`` on ``device`` (None: the GPU),
    with gradients turned on (the model builders make every parameter with
    ``requires_grad=False``, which serving relies on), and a fresh AdamW
    state.  With ``rules`` on a mesh of ranks, the params are this rank's
    slices (``models.api.init_params``) and the AdamW state is theirs: the
    whole state never exists on the rank."""
    params = model_api.init_params(generator, cfg, device, rules)
    params.requires_grad_(True)
    return TrainState(params=params, opt=adamw_init(params))


def train_state_axes(cfg: ModelConfig, zero1: bool = True) -> TrainState:
    p_axes = model_api.params_logical_axes(cfg)
    o_axes = zero1_axes(p_axes) if zero1 else p_axes
    return TrainState(
        params=p_axes,
        opt=AdamWState(step=(), master=o_axes, mu=o_axes, nu=o_axes),
    )


def train_state_specs(
    cfg: ModelConfig, rules: ShardingRules, zero1: bool = True
) -> TrainState:
    """The partition spec of every leaf of a train state, keyed as the
    port's state is: ``params`` and the optimizer's ``master``, ``mu`` and
    ``nu`` by parameter name (``named_parameters()``), ``step`` ``()``.
    Each is the reference's spec of that leaf with a stacked layer's
    leading entry taken off (a ``ranks.BlockedSpec`` where the family lays
    the leaf out as blocks, ``models.api.blocked_specs``)."""
    p_axes = model_api.params_logical_axes_by_name(cfg)
    o_axes = zero1_axes(p_axes) if zero1 else p_axes
    params = model_api.param_specs(cfg, rules)
    opt = model_api.blocked_specs(cfg, tree_specs(rules, o_axes))
    return TrainState(
        params=params,
        opt=AdamWState(step=(), master=opt, mu=dict(opt), nu=dict(opt)),
    )


def _drop_axis(spec: tuple, axis: str) -> tuple:
    """``spec`` with ``axis`` taken out of every entry."""
    out = []
    for entry in spec:
        axes = () if entry is None else \
            (entry,) if isinstance(entry, str) else tuple(entry)
        kept = tuple(a for a in axes if a != axis)
        out.append(kept[0] if len(kept) == 1 else kept or None)
    return tuple(out)


class _Layout:
    """Where a sharded step's batch rows, parameter slices and optimizer
    slices lie on the mesh, and which ranks its gradients are reduced
    over."""

    def __init__(self, cfg: ModelConfig, rules: ShardingRules, mesh,
                 zero1: bool):
        rules = rules.with_mesh(mesh)
        sizes = ranks.mesh_sizes(mesh)
        self.batch = batch_axes(rules)
        self.ranks = batch_ranks(rules)
        seq = rules.spec(("batch", "seq"))[1]
        if seq is not None and math.prod(
                sizes[a] for a in
                ((seq,) if isinstance(seq, str) else seq)) > 1:
            raise NotImplementedError(
                "a sequence split over ranks (the rules' 'seq' axis) has "
                "no counterpart in the port")
        if cfg.moe_flat_dispatch and (self.batch
                                      or model_ranks(mesh) > 1):
            raise NotImplementedError(
                "the flat MoE dispatch's capacity counts the global "
                "batch's tokens, which no rank holds, and its one buffer "
                "has no split over a 'model' axis; shard with the batched "
                "dispatch")
        # the gradients are reduced over the batch axes of more than one
        # rank (an axis of one would only copy them)
        self.reduced = tuple(a for a in self.batch if sizes[a] > 1)
        self.intra = tuple(a for a in self.reduced if a != "pod")
        self.inter = ("pod",) if "pod" in self.reduced else ()
        specs = train_state_specs(cfg, rules, zero1)
        self.param_specs = specs.params
        self.opt_specs = specs.opt.master
        # a params-shaped leaf is sliced over the data axes only: its
        # "model" split is the param's own
        self.zero_specs = {k: _drop_axis(v, "model")
                           for k, v in self.opt_specs.items()}
        with ranks.use_mesh(mesh):
            for name, spec in specs.params.items():
                if ranks.spec_shards(_drop_axis(spec, "model")):
                    raise NotImplementedError(
                        f"param {name} is split by {spec} over the batch "
                        "axes")
            self.model_split = {k for k, v in specs.params.items()
                                if ranks.spec_shards(v)}
            self.opt_sharded = any(ranks.spec_shards(s)
                                   for s in self.zero_specs.values())
        self.whole = {k: tuple(p.shape) for k, p in
                      model_api.param_shapes(cfg).named_parameters()}

    def local_batch(self, batch: dict) -> dict:
        """This rank's rows of the global batch."""
        if not self.batch:
            return batch
        idx = ranks.axis_index(self.batch)
        out = {}
        for key, x in batch.items():
            if x.shape[0] % self.ranks:
                raise ValueError(f"a global batch of {x.shape[0]} rows "
                                 f"does not split over {self.ranks} ranks")
            rows = x.shape[0] // self.ranks
            out[key] = x.narrow(0, idx * rows, rows)
        return out

    @torch.no_grad()
    def local_params(self, params: nn.Module) -> None:
        """Cut, in place, each parameter of its whole shape that the rules
        split over ``"model"`` to this rank's slice."""
        for name, p in params.named_parameters():
            if name in self.model_split and \
                    tuple(p.shape) == self.whole[name]:
                p.data = ranks.spec_slice(p.data, self.param_specs[name]) \
                    .clone(memory_format=torch.contiguous_format)

    def local_opt(self, opt: AdamWState, named: dict) -> AdamWState:
        """The optimizer state with each leaf this rank's slice: a leaf of
        its param's whole shape is sliced by its spec, one of the rank's
        param slice's shape over the data axes (each a copy); a leaf of
        the slice's shape is kept."""
        def part(tree):
            out = {}
            for name, x in tree.items():
                if tuple(x.shape) == self.whole[name]:
                    spec = self.opt_specs[name]
                elif x.shape == named[name].shape:
                    spec = self.zero_specs[name]
                else:
                    spec = None
                if spec is not None and ranks.spec_shards(spec):
                    x = ranks.spec_slice(x, spec).clone(
                        memory_format=torch.contiguous_format)
                out[name] = x
            return out
        return AdamWState(opt.step, part(opt.master), part(opt.mu),
                          part(opt.nu))


def local_train_state(state: TrainState, cfg: ModelConfig,
                      rules: ShardingRules, mesh,
                      zero1: bool = True) -> TrainState:
    """This rank's part of a whole train state under ``rules`` on ``mesh``
    (the optimizer's leaves sliced where their specs split them, the
    params where they split over ``"model"``, the latter in place in the
    given module): what the sharded step keeps, made before the first step
    so that the whole state can be freed."""
    layout = _Layout(cfg, rules, mesh, zero1)
    with ranks.use_mesh(mesh):
        layout.local_params(state.params)
        named = dict(state.params.named_parameters())
        return TrainState(state.params, layout.local_opt(state.opt, named))


def make_train_step(
    cfg: ModelConfig,
    rules=None,
    mesh=None,
    *,
    microbatches: int = 1,
    lr_schedule: Callable | None = None,
    weight_decay: float = 0.1,
    grad_clip: float = 1.0,
    zero1: bool = True,
    donate: bool = True,
):
    """Returns ``step_fn(state, batch) -> (state, metrics)``, metrics the
    0-d tensors ``loss``, ``grad_norm`` and ``lr`` (read them with
    ``float()``, which waits for the device).

    With ``microbatches`` 1 the gradients stay in the param dtype until
    AdamW casts them; with more, the batch is split along its first axis,
    the gradients add into f32 buffers and are scaled by ``1/m``, and the
    loss is the mean of the microbatch losses, as the reference's
    ``lax.scan``.  ``donate=True`` updates the given state's tensors in
    place (the reference donates its buffers); ``donate=False`` leaves it
    intact and returns a new state.

    With ``rules`` and ``mesh`` (a ``DeviceMesh`` of ranks) every rank
    calls the step with the same global batch and its own state (a whole
    state is sliced at the first step, as the reference's ``jit`` reshards
    an argument; ``local_train_state`` does it beforehand); the loss and
    the gradient norm it returns are the global batch's, on every rank.
    ``zero1`` shards the optimizer state where the rules map ``zero1``
    (``tp_rules``); under ``dp_rules`` it stays whole."""
    if cfg.attention_impl == "cuda":
        raise ValueError(
            "attention_impl 'cuda': the hand-written CUDA kernels are "
            "forward-only, as the reference's Pallas kernels are; train "
            "with attention_impl='xla', the reference's default")
    lr_schedule = lr_schedule or functools.partial(
        cosine_with_warmup, peak_lr=3e-4, warmup_steps=50, total_steps=1000
    )
    layout = None
    if rules is not None and mesh is not None:
        rules = rules.with_mesh(mesh)
        layout = _Layout(cfg, rules, mesh, zero1)
    else:
        rules = None

    def loss_and_grads(params, leaves, batch):
        loss = model_api.train_loss(params, batch, cfg, rules)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    def compute_grads(params, leaves, batch):
        if microbatches <= 1:
            return loss_and_grads(params, leaves, batch)
        split = {k: x.reshape((microbatches, x.shape[0] // microbatches)
                              + tuple(x.shape[1:]))
                 for k, x in batch.items()}
        loss = torch.zeros((), dtype=torch.float32,
                           device=leaves[0].device)
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in leaves]
        for i in range(microbatches):
            mb_loss, grads = loss_and_grads(
                params, leaves, {k: x[i] for k, x in split.items()})
            loss = loss + mb_loss
            for a, g in zip(acc, grads):
                a.add_(g)
            del grads
        inv = 1.0 / microbatches
        return loss * inv, [a.mul_(inv) for a in acc]

    def step_fn(state: TrainState, batch: dict):
        if not donate:
            state = copy.deepcopy(state)
        named = dict(state.params.named_parameters())
        if layout is None:
            loss, grads = compute_grads(state.params, list(named.values()),
                                        batch)
            lr = lr_schedule(state.opt.step)
            _, opt, metrics = adamw_update(
                dict(zip(named, grads)), state.opt, lr,
                weight_decay=weight_decay, grad_clip=grad_clip,
                param_dtype=cfg.torch_dtype, out=named,
            )
            metrics["loss"] = loss
            return TrainState(params=state.params, opt=opt), metrics
        with ranks.use_mesh(mesh):
            return sharded_step(state, named, batch)

    @torch.no_grad()
    def reduce(loss, grads: dict):
        """The global batch's loss and gradients on every rank, each leaf
        all-reduced in turn in place of the rank's own (so that one leaf's
        two copies exist at a time)."""
        if layout.ranks == 1:
            return loss
        inv = 1.0 / layout.ranks
        for k in grads:
            grads[k] = hierarchical_grad_allreduce(
                grads[k], layout.intra, layout.inter).mul_(inv)
        return ranks.psum(loss.reshape(1), layout.reduced).reshape(()) * inv

    def sharded_step(state, named, batch):
        layout.local_params(state.params)
        named = dict(state.params.named_parameters())
        opt = layout.local_opt(state.opt, named)
        loss, grads = compute_grads(state.params, list(named.values()),
                                    layout.local_batch(batch))
        grads = dict(zip(named, grads))
        loss = reduce(loss, grads)
        # the whole gradient's norm: the split leaves' squares summed over
        # "model", each replicated leaf counted once
        gnorm = global_norm(grads, split=layout.model_split)
        lr = lr_schedule(state.opt.step)
        kw = dict(weight_decay=weight_decay, grad_clip=grad_clip,
                  param_dtype=cfg.torch_dtype, grad_norm=gnorm)
        if not layout.opt_sharded:
            _, opt, metrics = adamw_update(grads, opt, lr, out=named, **kw)
        else:
            specs = layout.zero_specs
            slices = {k: ranks.spec_slice(g, specs[k])
                      for k, g in grads.items()}
            del grads
            new = {k: torch.empty(s.shape, dtype=named[k].dtype,
                                  device=s.device)
                   for k, s in slices.items()}
            _, opt, metrics = adamw_update(slices, opt, lr, out=new, **kw)
            del slices
            with torch.no_grad():
                for k, p in named.items():
                    p.copy_(ranks.spec_gather(new.pop(k), specs[k]))
        metrics["loss"] = loss
        return TrainState(params=state.params, opt=opt), metrics

    return step_fn

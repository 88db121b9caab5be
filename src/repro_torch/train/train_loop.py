"""Train-step factory: loss -> gradients -> AdamW, with microbatch gradient
accumulation and the reference's buffer donation as in-place updates.

The step runs eagerly on one device, through the models' plain attention
and scans (``attention_impl`` "xla", the reference's default and the path
it trains through): the hand-written kernels are forward-only, as the
reference's Pallas kernels are, so ``make_train_step`` refuses a config
that names them.  Sharded training (the reference's ``rules`` and ``mesh``,
``train_state_specs``) waits for ROADMAP Queue A item 10.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
from typing import Any, Callable

import torch
import torch.nn as nn

from repro_torch.models import api as model_api
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw_init, adamw_update, cosine_with_warmup
from repro_torch.optim.adamw import AdamWState, zero1_axes

#: what a sharded train step waits for
QUEUED_DIST = ("sharded training (rules, mesh) waits for the port's "
               "logical-axis rules and collectives over several ranks, "
               "ROADMAP Queue A item 10")


@dataclasses.dataclass
class TrainState:
    params: nn.Module
    opt: AdamWState

    @property
    def step(self) -> torch.Tensor:
        return self.opt.step


def init_train_state(generator: torch.Generator, cfg: ModelConfig,
                     device: torch.device | str | None = None) -> TrainState:
    """Random parameters from ``generator`` on ``device`` (None: the GPU),
    with gradients turned on (the model builders make every parameter with
    ``requires_grad=False``, which serving relies on), and a fresh AdamW
    state."""
    params = model_api.init_params(generator, cfg, device)
    params.requires_grad_(True)
    return TrainState(params=params, opt=adamw_init(params))


def train_state_axes(cfg: ModelConfig, zero1: bool = True) -> TrainState:
    p_axes = model_api.params_logical_axes(cfg)
    o_axes = zero1_axes(p_axes) if zero1 else p_axes
    return TrainState(
        params=p_axes,
        opt=AdamWState(step=(), master=o_axes, mu=o_axes, nu=o_axes),
    )


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
    intact and returns a new state.  ``zero1`` names the optimizer state's
    sharding over ranks, which one device does not use."""
    if rules is not None or mesh is not None:
        raise NotImplementedError(QUEUED_DIST)
    if cfg.attention_impl == "cuda":
        raise ValueError(
            "attention_impl 'cuda': the hand-written CUDA kernels are "
            "forward-only, as the reference's Pallas kernels are; train "
            "with attention_impl='xla', the reference's default")
    del zero1
    lr_schedule = lr_schedule or functools.partial(
        cosine_with_warmup, peak_lr=3e-4, warmup_steps=50, total_steps=1000
    )

    def loss_and_grads(params, leaves, batch):
        loss = model_api.train_loss(params, batch, cfg)
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
        loss, grads = compute_grads(state.params, list(named.values()), batch)
        lr = lr_schedule(state.opt.step)
        _, opt, metrics = adamw_update(
            dict(zip(named, grads)), state.opt, lr,
            weight_decay=weight_decay, grad_clip=grad_clip,
            param_dtype=cfg.torch_dtype, out=named,
        )
        metrics["loss"] = loss
        return TrainState(params=state.params, opt=opt), metrics

    return step_fn

"""Shared layer primitives: norms, RoPE, MLP variants, losses, init, remat.

Weights keep the reference's layout: a projection is ``x @ W`` with ``W`` of
shape (in, out).  Initialisers take a ``torch.Generator`` where the
reference takes a JAX key, and make the numbers on the generator's device.
"""

from __future__ import annotations

import functools
import math
from typing import Mapping, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.device import resolve_device
from repro_torch.dist import tensor_parallel as tp
from repro_torch.dist.sharding import constrain, model_split

# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_device(generator: torch.Generator,
                device: torch.device | str | None) -> torch.device:
    """The device parameters are made on (None: the GPU); ``generator``
    must live there.  With no generator, only the ``meta`` device, which
    takes shapes without numbers (``models.api.param_shapes``)."""
    device = resolve_device(device)
    if generator is None:
        if device.type == "meta":
            return device
        raise ValueError(f"parameters on {device} need a generator")
    if torch.device(generator.device).type != device.type:
        raise ValueError(f"the generator is on {generator.device}, the "
                         f"parameters go to {device}")
    return device


def normal_init(generator: torch.Generator, shape: Sequence[int],
                scale: float, dtype: torch.dtype,
                device: torch.device | str | None = None) -> torch.Tensor:
    """Standard normal in float32 times ``scale``, cast to ``dtype``."""
    x = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                    device=device if device is not None else generator.device)
    return x.mul_(scale).to(dtype)


def fan_in_init(generator: torch.Generator, shape: Sequence[int],
                dtype: torch.dtype,
                device: torch.device | str | None = None) -> torch.Tensor:
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    return normal_init(generator, shape, 1.0 / math.sqrt(fan_in), dtype,
                       device)


# ---------------------------------------------------------------------------
# Norms (computed in float32, cast back)
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with a zero-initialised scale: multiplies by ``1 + scale``."""
    dtype = x.dtype
    x = x.float()
    var = (x * x).mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float())).to(dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * scale.float() + bias.float()).to(dtype)


def apply_norm(x: torch.Tensor, params: Mapping[str, torch.Tensor],
               kind: str) -> torch.Tensor:
    if kind == "rmsnorm":
        return rms_norm(x, params["scale"])
    return layer_norm(x, params["scale"], params["bias"])


def norm_init(d: int, kind: str, dtype: torch.dtype,
              device: torch.device | str | None = None) -> dict:
    if kind == "rmsnorm":
        return {"scale": torch.zeros((d,), dtype=dtype, device=device)}
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# RoPE (rotates the two halves of the head dimension)
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float,
               device: torch.device | str | None = None) -> torch.Tensor:
    return _rope_freqs(head_dim, float(theta), torch.device(device or "cpu"))


@functools.lru_cache(maxsize=64)
def _rope_freqs(head_dim: int, theta: float,
                device: torch.device) -> torch.Tensor:
    """Made once per (head_dim, theta, device): a tensor made from a Python
    number on the GPU is a blocking copy, which would stall every layer."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32),
                            exponent)
    return freqs.to(device)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float,
                heads: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) of the rotation angles for ``positions`` (..., S), each
    over the whole head dimension and float32: ``cos`` repeated over both
    halves, ``sin`` negated on the first half, so that
    ``x * cos + rotate_half(x) * sin`` is the reference's
    ``[x1 cos - x2 sin, x2 cos + x1 sin]`` bit for bit.  With ``heads``
    they broadcast over a head axis before the last.  A forward pass makes
    them once for all its layers."""
    freqs = rope_freqs(head_dim, theta, positions.device)  # (d/2,)
    angles = positions[..., None].float() * freqs  # (..., S, d/2)
    if heads:
        angles = angles[..., None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    return torch.cat([cos, cos], dim=-1), torch.cat([-sin, sin], dim=-1)


def apply_rope_tables(x: torch.Tensor, cos: torch.Tensor,
                      sin: torch.Tensor) -> torch.Tensor:
    """Rotate the two halves of the head dimension by ``rope_tables``;
    computed in float32 and cast back."""
    xf = x.float()
    x1, x2 = xf.chunk(2, dim=-1)
    return (xf * cos + torch.cat([x2, x1], dim=-1) * sin).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D) or (..., S, D); positions: (..., S)."""
    heads = x.ndim == positions.ndim + 2  # head axis present
    return apply_rope_tables(x, *rope_tables(positions, x.shape[-1], theta,
                                             heads))


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def mlp_init(generator: torch.Generator, d_model: int, d_ff: int,
             activation: str, dtype: torch.dtype,
             device: torch.device | str | None = None) -> dict:
    p = {
        "w_up": fan_in_init(generator, (d_model, d_ff), dtype, device),
        "w_down": fan_in_init(generator, (d_ff, d_model), dtype, device),
    }
    if activation in ("swiglu", "geglu"):
        p["w_gate"] = fan_in_init(generator, (d_model, d_ff), dtype, device)
    return p


def mlp_apply(params: Mapping[str, torch.Tensor], x: torch.Tensor,
              activation: str, rules=None) -> torch.Tensor:
    """Where ``rules`` split ``d_ff`` over more than one rank of
    ``"model"``, ``params`` are this rank's slices: ``w_up`` and ``w_gate``
    column-split, ``w_down`` row-split and its product summed over the
    ranks (Megatron); otherwise nothing is split and nothing reduced."""
    split = model_split(rules, "d_ff") > 1
    if split:
        x = tp.copy_to_model(x, rules.mesh)
    up = x @ params["w_up"]
    if activation == "swiglu":
        h = F.silu(x @ params["w_gate"]) * up
    elif activation == "geglu":
        h = F.gelu(x @ params["w_gate"], approximate="tanh") * up
    else:  # gelu
        h = F.gelu(up, approximate="tanh")
    h = constrain(h, rules, ("batch", "seq", "d_ff"))
    out = h @ params["w_down"]
    return tp.reduce_from_model(out, rules.mesh) if split else out


def mlp_logical_axes(activation: str) -> dict:
    p = {"w_up": ("d_model", "d_ff"), "w_down": ("d_ff", "d_model")}
    if activation in ("swiglu", "geglu"):
        p["w_gate"] = ("d_model", "d_ff")
    return p


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 z_loss: float = 0.0, rules=None) -> torch.Tensor:
    """Mean token cross-entropy; logits (..., V), labels (...) int.  Where
    ``rules`` split ``vocab`` over more than one rank of ``"model"``, the
    logits are this rank's slice of the vocab and the vocab-parallel
    cross-entropy gives every rank the whole loss."""
    if model_split(rules, "vocab") > 1:
        return tp.vocab_parallel_xent(logits, labels, z_loss,
                                      rules.mesh).mean()
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    loss = lse - gold
    if z_loss:
        loss = loss + z_loss * lse ** 2
    return loss.mean()


def causal_lm_loss(logits: torch.Tensor, tokens: torch.Tensor,
                   rules=None) -> torch.Tensor:
    """Next-token prediction: logits[:, :-1] predict tokens[:, 1:]
    (vocab-split logits under ``rules``, as ``softmax_xent``)."""
    return softmax_xent(logits[:, :-1, :], tokens[:, 1:], rules=rules)


# ---------------------------------------------------------------------------
# Remat
# ---------------------------------------------------------------------------

#: the matrix products whose outputs remat policy "dots" saves (``x @ W``
#: runs as ``mm``, an einsum over heads as ``bmm``)
DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
           torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def remat_policy_of(cfg):
    """The ``context_fn`` of ``torch.utils.checkpoint.checkpoint`` for
    ``cfg.remat_policy``, the reference's checkpoint policy:

    * ``nothing`` (None: checkpoint's default) — full remat: minimum memory,
      recomputes the whole layer;
    * ``dots`` — save the matmul outputs (``DOT_OPS``), as
      ``checkpoint_dots``: about 1/3 less recompute for
      ~(q_dim + 2 kv_dim + 2 d_ff) extra values a token and layer.
    """
    if getattr(cfg, "remat_policy", "nothing") == "dots":
        return functools.partial(create_selective_checkpoint_contexts,
                                 list(DOT_OPS))
    return None


def remat_call(cfg, mode: str, fn, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` (non-reentrant, with
    ``remat_policy_of(cfg)``) where the reference wraps a layer in
    ``jax.checkpoint``: ``cfg.remat`` in train mode, and only while autograd
    records (a forward under ``torch.no_grad`` has nothing to recompute)."""
    if not (cfg.remat and mode == "train" and torch.is_grad_enabled()):
        return fn(*args)
    context = remat_policy_of(cfg)
    if context is None:
        return checkpoint(fn, *args, use_reentrant=False)
    return checkpoint(fn, *args, use_reentrant=False, context_fn=context)

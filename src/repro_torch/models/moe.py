"""Mixture-of-Experts decoder (granite-3.0 MoE family): top-k routing with
capacity-based dispatch.

The attention half of a layer is the dense transformer's
(``transformer._attention_block``: the hand-written flash- and
decode-attention kernels with ``attention_impl="cuda"``); the MLP half
routes each token to its top-k experts.  In Lightning terms the expert axis
is a launch-grid axis whose access region intersects several chunks (a
token's experts live in different rows of the (E, C, D) dispatch buffer):
the scatter into that buffer is the all-to-all the planner would emit over
several devices, and on one device an accumulating ``index_put_``.  The
expert products are batched matrix products over the expert axis, as the
reference computes them outside any Pallas kernel.

The parameters are a ``Transformer`` whose ``DecoderLayer``s hold
``router`` (d_model, E) and a ``moe`` dict (``w_up``, ``w_gate`` (E,
d_model, d_ff), ``w_down`` (E, d_ff, d_model)) in place of ``mlp``.  The
forward pass is a Python loop over the layers.

Over a ``"model"`` axis of more than one rank the attention half, the
embedding and the head are the dense family's tensor-parallel layers, and
the routed MLP takes one of the two placements ``rules_for`` gives, as the
reference's GSPMD places them.  The router is whole on every rank and
every rank of the axis holds the same tokens, so the routing (and with it
the capacity, the drops and the load-balance loss) is the same on each:

* experts split (``n_experts`` a multiple of the ranks): each rank holds
  ``E / m`` experts, fills only their rows of the (B, E / m, C, D)
  buffer, runs them and gathers back only their outputs; no all-to-all;
* experts whole, d_ff split (the rest): every rank fills the whole buffer
  and runs every expert on its d_ff slice, the dense MLP's column- and
  row-split, one expert at a time.

Either way a rank's output is a partial sum, added over the ranks by
``reduce_from_model``; the tokens enter the experts and the gates enter
the combine through ``copy_to_model``, so that their gradients (partial on
each rank) are summed, while the load-balance loss, formed from the whole
router probabilities that every rank holds, reaches the router once.

Routing takes the top k experts by a stable descending sort of the router
probabilities, so that tied probabilities go to the lower expert index, as
``jax.lax.top_k`` breaks ties; ``torch.topk`` promises no order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dist import ranks
from repro_torch.dist import tensor_parallel as tp
from repro_torch.dist.sharding import (
    batch_axes,
    batch_ranks,
    constrain,
    model_split,
    psum_batch,
)

from . import kvcache, transformer
from .config import ModelConfig
from .layers import (apply_norm, causal_lm_loss, fan_in_init, init_device,
                     norm_init, normal_init, remat_call, rope_tables)
from .layers import remat_policy_of  # noqa: F401  (public, as the reference's)
from .transformer import Transformer

AUX_LOSS_COEF = 0.01


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def init_layer(generator: torch.Generator, cfg: ModelConfig,
               device: torch.device | str | None = None) -> dict:
    """One layer's weights on ``device`` (None: the generator's)."""
    device = device if device is not None else generator.device
    dt = cfg.torch_dtype
    p = transformer.init_layer(generator, cfg, device)
    del p["mlp"]
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    p["router"] = fan_in_init(generator, (d, e), dt, device)
    p["moe"] = {
        "w_up": fan_in_init(generator, (e, d, f), dt, device),
        "w_gate": fan_in_init(generator, (e, d, f), dt, device),
        "w_down": fan_in_init(generator, (e, f, d), dt, device),
    }
    return p


def layer_logical_axes(cfg: ModelConfig) -> dict:
    p = transformer.layer_logical_axes(cfg)
    del p["mlp"]
    p["router"] = ("d_model", None)
    p["moe"] = {
        "w_up": ("experts", "d_model", "d_ff"),
        "w_gate": ("experts", "d_model", "d_ff"),
        "w_down": ("experts", "d_ff", "d_model"),
    }
    return p


def init_params(generator: torch.Generator, cfg: ModelConfig,
                device: torch.device | str | None = None) -> Transformer:
    """Random parameters made on ``device`` (None: the GPU) from
    ``generator``, which must live on that device."""
    device = init_device(generator, device)
    dt = cfg.torch_dtype
    embed = normal_init(generator, (cfg.vocab, cfg.d_model), 0.02, dt, device)
    layers = [init_layer(generator, cfg, device) for _ in range(cfg.n_layers)]
    lm_head = None
    if not cfg.tie_embeddings:
        lm_head = fan_in_init(generator, (cfg.d_model, cfg.vocab), dt, device)
    return Transformer(embed, layers,
                       norm_init(cfg.d_model, cfg.norm, dt, device), lm_head)


def params_logical_axes(cfg: ModelConfig) -> dict:
    p = transformer.params_logical_axes(cfg)

    def stack(ax):
        if isinstance(ax, dict):
            return {k: stack(v) for k, v in ax.items()}
        return ("layers",) + ax

    p["layers"] = stack(layer_logical_axes(cfg))
    return p


# ---------------------------------------------------------------------------
# Dispatch and combine: a scatter-add and a gather, each the other's adjoint
# ---------------------------------------------------------------------------


def _rows(idx: torch.Tensor) -> torch.Tensor:
    """The batch index (B, 1) that goes with (B, N) expert and slot
    indices."""
    return torch.arange(idx.shape[0], device=idx.device)[:, None]


def _scatter_add(idx_e, idx_c, tok, e_buf: int, cap: int) -> torch.Tensor:
    """(B, e_buf, cap, D) zeros with ``tok[b, n]`` added at ``(b, idx_e[b,
    n], idx_c[b, n])``.  Accumulating: a dropped token adds its zero at a
    clipped slot that a kept token may hold.  By ``index_add_`` on the
    flattened slots (atomic adds on the GPU, where ``index_put_``'s
    accumulating form sorts the indices first)."""
    b, _, d = tok.shape
    slot = (_rows(idx_e) * e_buf + idx_e) * cap + idx_c
    buf = tok.new_zeros((b * e_buf * cap, d))
    buf.index_add_(0, slot.reshape(-1), tok.reshape(-1, d))
    return buf.view(b, e_buf, cap, d)


def _gather(buf, idx_e, idx_c) -> torch.Tensor:
    """``buf[b, idx_e[b, n], idx_c[b, n]]``: (B, N, D)."""
    return buf[_rows(idx_e), idx_e, idx_c]


class _DispatchScatter(torch.autograd.Function):
    """The reference's ``_dispatch_scatter`` custom-vjp pair: the adjoint
    of the batched scatter-add is the batched gather."""

    @staticmethod
    def forward(ctx, idx_e, idx_c, tok, e_buf, cap):
        ctx.save_for_backward(idx_e, idx_c)
        return _scatter_add(idx_e, idx_c, tok, e_buf, cap)

    @staticmethod
    def backward(ctx, g):
        idx_e, idx_c = ctx.saved_tensors
        return None, None, _gather(g, idx_e, idx_c), None, None


class _CombineGather(torch.autograd.Function):
    """The reference's ``_combine_gather`` custom-vjp pair: the adjoint of
    the batched gather is the batched scatter-add."""

    @staticmethod
    def forward(ctx, buf, idx_e, idx_c, e_buf, cap):
        ctx.save_for_backward(idx_e, idx_c)
        ctx.e_buf, ctx.cap = e_buf, cap
        return _gather(buf, idx_e, idx_c)

    @staticmethod
    def backward(ctx, g):
        idx_e, idx_c = ctx.saved_tensors
        return (_scatter_add(idx_e, idx_c, g, ctx.e_buf, ctx.cap),
                None, None, None, None)


def _dispatch_scatter(idx_e, idx_c, tok, e_buf, cap, rules):
    """Tokens (B, N, D) into the (B, e_buf, cap, D) dispatch buffer."""
    buf = _DispatchScatter.apply(idx_e, idx_c, tok, e_buf, cap)
    return constrain(buf, rules,
                     ("batch", "experts_buf", "expert_cap", "d_model"))


def _combine_gather(buf, idx_e, idx_c, e_buf, cap, rules):
    """Each (token, choice)'s row of the expert outputs: (B, N, D)."""
    out = _CombineGather.apply(buf, idx_e, idx_c, e_buf, cap)
    return constrain(out, rules, ("batch", None, "d_model"))


# ---------------------------------------------------------------------------
# MoE MLP
# ---------------------------------------------------------------------------


def _route(lp, x: torch.Tensor, cfg: ModelConfig):
    """Router probabilities (..., E) in f32, and the top-k gates (their
    sum normalised to 1) and experts (..., k), ties to the lower index."""
    probs = torch.softmax((x @ lp.router).float(), dim=-1)
    gate_vals, expert_idx = torch.sort(probs, dim=-1, descending=True,
                                       stable=True)
    gate_vals = gate_vals[..., :cfg.top_k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    return probs, gate_vals, expert_idx[..., :cfg.top_k]


def _experts_buffered(cfg: ModelConfig) -> int:
    """Rows of the dispatch buffer's expert axis: ``n_experts`` rounded up
    to a multiple of ``expert_pad_to`` (dead experts get no tokens)."""
    e = cfg.n_experts
    if cfg.expert_pad_to and e % cfg.expert_pad_to:
        return (e + cfg.expert_pad_to - 1) // cfg.expert_pad_to \
            * cfg.expert_pad_to
    return e


def _pad_experts(w: torch.Tensor, e_buf: int) -> torch.Tensor:
    if w.shape[0] == e_buf:
        return w
    return torch.cat([w, w.new_zeros((e_buf - w.shape[0],) + w.shape[1:])])


def _queue_positions(onehot: torch.Tensor, axis: int) -> torch.Tensor:
    """Each (token, choice)'s place in its expert's queue, in
    (choice-major, token) priority order.  ``onehot`` (..., T, k, E);
    ``axis`` is T's.  The running count is taken along the last axis of an
    (..., E, k T) copy: exact in f32, and a scan along a tensor's outer
    axis has only E columns to spread over the GPU."""
    flat = onehot.transpose(axis, axis + 1)  # (..., k, T, E)
    shape = flat.shape
    flat = flat.reshape(shape[:axis] + (-1, shape[-1])) \
        .transpose(-1, -2).contiguous()  # (..., E, k T)
    pos = (flat.cumsum(-1) - flat).transpose(-1, -2).reshape(shape)
    return (pos.transpose(axis, axis + 1) * onehot).sum(-1)


def _expert_ffn(buf: torch.Tensor, lp, e_buf: int, rules,
                batched: bool) -> torch.Tensor:
    """SwiGLU of every expert on its rows of the dispatch buffer, (B, E, C,
    D) when ``batched``, else (E, C, D)."""
    w = {n: _pad_experts(lp.moe[n], e_buf)
         for n in ("w_gate", "w_up", "w_down")}
    spec = "bec" if batched else "ec"
    h = torch.einsum(f"{spec}d,edf->{spec}f", buf, w["w_gate"])
    up = torch.einsum(f"{spec}d,edf->{spec}f", buf, w["w_up"])
    h = F.silu(h) * up
    axes = ("batch",) * batched + ("experts_buf", "expert_cap")
    h = constrain(h, rules, axes + ("d_ff",))
    out = torch.einsum(f"{spec}f,efd->{spec}d", h, w["w_down"])
    return constrain(out, rules, axes + ("d_model",))


def _model_placement(rules) -> str | None:
    """How ``rules`` split the routed MLP over the ``"model"`` axis:
    ``"experts"``, ``"d_ff"`` (experts whole), or None (nothing split)."""
    if model_split(rules, "experts") > 1:
        return "experts"
    if model_split(rules, "d_ff") > 1:
        return "d_ff"
    return None


def moe_mlp(
    lp,
    x: torch.Tensor,  # (B, S, D)
    cfg: ModelConfig,
    rules,
    mode: str = "train",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k routed expert MLP.  Returns (output, aux load-balance loss).

    Dispatch is batched: the buffer keeps the batch axis, (B, E, C_row,
    D), with a capacity of ``max(1, int(S k / E capacity_factor))`` tokens
    an expert a row; a (token, choice) past its expert's capacity is
    dropped (it adds zero at the last slot and gets zero back).  Over a
    split ``"model"`` axis, see the module's docstring.

    In ``"train"`` mode over a batch split across ranks, the load
    statistics are the global batch's (an all-reduce each over the batch
    ranks); in ``"prefill"`` and ``"decode"`` they are the rank's own rows,
    with no collective: serving drops ``aux``, and an engine over a data
    axis runs a prefill on the owner's model group alone, where a
    collective over the batch ranks would never complete."""
    placement = _model_placement(rules)
    if cfg.moe_flat_dispatch:
        if placement is not None:
            raise NotImplementedError(
                "the flat MoE dispatch over a split 'model' axis: shard "
                "with the batched dispatch")
        return _moe_mlp_flat(lp, x, cfg, rules)
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    e_buf = _experts_buffered(cfg)
    cap = max(1, int(s * k / e * cfg.capacity_factor))

    probs, gate_vals, expert_idx = _route(lp, x, cfg)  # (B, S, E), (B, S, k)
    onehot = F.one_hot(expert_idx, e).float()  # (B, S, k, E)
    if mode == "train" and batch_axes(rules):
        # The load statistics are the global batch's, as GSPMD forms them
        # from a batch split over ranks: sums over every rank's rows.
        rows = b * batch_ranks(rules)
        f = psum_batch(onehot.sum(dim=(0, 1, 2)), rules) / rows / s
        pbar = psum_batch(probs.sum(dim=(0, 1)), rules) / (rows * s)
    else:
        f = onehot.sum(dim=(1, 2)).mean(dim=0) / s
        pbar = probs.mean(dim=(0, 1))
    aux = e * torch.sum(f * pbar)

    pos_in_exp = _queue_positions(onehot, 1)  # (B, S, k)
    keep = (pos_in_exp < cap) & (gate_vals > 0)
    if placement is not None:
        mesh = rules.mesh
        x = tp.copy_to_model(x, mesh)
        gate_vals = tp.copy_to_model(gate_vals, mesh)
    if placement == "experts":
        # this rank's experts only: the others' choices add zero at a
        # clipped row and get zero back, as a dropped choice does
        e_buf = lp.moe["w_up"].shape[0]
        with ranks.use_mesh(mesh):
            lo = ranks.axis_index(tp.MODEL) * e_buf
        expert_idx = expert_idx - lo
        keep = keep & (expert_idx >= 0) & (expert_idx < e_buf)
        expert_idx = expert_idx.clamp(0, e_buf - 1)
    idx_e = expert_idx.reshape(b, s * k)
    idx_c = torch.clamp(pos_in_exp.long(), 0, cap - 1).reshape(b, s * k)
    # Gates in the model's dtype before any multiply, as the reference.
    w = keep.reshape(b, s * k).to(x.dtype)
    tok_rep = torch.repeat_interleave(x, k, dim=1) * w[..., None]

    buf = _dispatch_scatter(idx_e, idx_c, tok_rep, e_buf, cap, rules)
    out_buf = _expert_ffn(buf, lp, e_buf, rules, batched=True)
    gathered = _combine_gather(out_buf, idx_e, idx_c, e_buf, cap, rules)
    gates = gate_vals.to(x.dtype).reshape(b, s * k)[..., None]
    gathered = gathered * gates * w[..., None]
    out = gathered.reshape(b, s, k, d).sum(dim=2)
    if placement is not None:
        out = tp.reduce_from_model(out, mesh)
    return out, aux


def _moe_mlp_flat(
    lp,
    x: torch.Tensor,  # (B, S, D)
    cfg: ModelConfig,
    rules,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The batch-flattened dispatch (the reference's ablation baseline):
    one (E, C, D) buffer for all B S tokens."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    xt = x.reshape(t, d)

    probs, gate_vals, expert_idx = _route(lp, xt, cfg)  # (T, E), (T, k)
    onehot = F.one_hot(expert_idx, e).float()  # (T, k, E)
    f = onehot.sum(dim=(0, 1)) / t
    pbar = probs.mean(dim=0)
    aux = e * torch.sum(f * pbar)

    cap = max(1, int(t * k / e * cfg.capacity_factor))
    pos_in_exp = _queue_positions(onehot, 0)  # (T, k)
    keep = (pos_in_exp < cap) & (gate_vals > 0)

    e_buf = _experts_buffered(cfg)
    idx_e = expert_idx.reshape(1, -1)
    idx_c = torch.clamp(pos_in_exp.long(), 0, cap - 1).reshape(1, -1)
    weights = keep.reshape(-1).to(x.dtype)
    tok_rep = torch.repeat_interleave(xt, k, dim=0) * weights[:, None]
    buf = _scatter_add(idx_e, idx_c, tok_rep[None], e_buf, cap)[0]
    buf = constrain(buf, rules, ("experts_buf", "expert_cap", "d_model"))
    out_buf = _expert_ffn(buf, lp, e_buf, rules, batched=False)

    gathered = _gather(out_buf[None], idx_e, idx_c)[0]  # (T k, D)
    gathered = gathered * (gate_vals.reshape(-1)[:, None]
                           * weights[:, None]).to(x.dtype)
    return gathered.reshape(t, k, d).sum(dim=1).reshape(b, s, d), aux


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _layer_fn(cfg: ModelConfig, rules, mode: str, x: torch.Tensor, lp,
              cache_l: dict | None, positions: torch.Tensor, rope=None,
              run=kvcache.WHOLE):
    """One layer: the dense transformer's attention block, then the routed
    MLP.  Returns (x, the layer's cache, its aux loss)."""
    x = constrain(x, rules, ("batch", "seq", "d_model"))
    x, new_cache_l = transformer._attention_block(
        lp, x, cfg, rules, positions, mode, cache_l, rope=rope, run=run)
    h = apply_norm(x, lp.mlp_norm, cfg.norm)
    moe_out, aux = moe_mlp(lp, h, cfg, rules, mode)
    return x + moe_out, new_cache_l, aux


def forward(
    params: Transformer,
    tokens: torch.Tensor,  # (B, S) int — or (B, S, D) pre-embedded
    cfg: ModelConfig,
    rules=None,
    mode: str = "train",  # train | prefill | decode
    cache: kvcache.Cache | None = None,
    extra_embeds=None,
) -> tuple[torch.Tensor, kvcache.Cache | None, torch.Tensor]:
    """Logits (B, S, vocab), or (B, 1, vocab) in decode mode, the cache
    (its buffers written in place, ``pos`` advanced by S in a new tensor)
    and the mean over layers of the aux load-balance loss.  Where ``rules``
    split the vocab, train logits are this rank's slice, as the dense
    family's.
    ``extra_embeds`` is accepted for the reference's signature."""
    del extra_embeds
    x = transformer._embed(params, tokens, rules) if tokens.ndim == 2 \
        else tokens
    b, s, _ = x.shape
    steps = torch.arange(s, device=x.device, dtype=torch.int32)
    if mode == "decode":
        assert cache is not None
        positions = cache["pos"][:, None] + steps[None, :]
    else:
        positions = steps[None, :].expand(b, s)
    rope = rope_tables(positions, cfg.head_dim, cfg.rope_theta)

    layer_caches = kvcache.layer_slice(cache) if cache is not None else None
    run = kvcache.cache_run(cache, rules)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, lp in enumerate(params.layers):
        cache_l = None
        if layer_caches is not None:
            cache_l = {name: buf[i] for name, buf in layer_caches.items()}
        x, _, layer_aux = remat_call(cfg, mode, _layer_fn, cfg, rules, mode,
                                     x, lp, cache_l, positions, rope, run)
        aux = aux + layer_aux

    new_cache = None
    if cache is not None:
        new_cache = dict(cache)
        new_cache["pos"] = cache["pos"] + s

    logits = transformer._logits(params, x, cfg, rules, mode)
    return logits, new_cache, aux / cfg.n_layers


def train_loss(
    params: Transformer,
    batch: dict,
    cfg: ModelConfig,
    rules=None,
) -> torch.Tensor:
    logits, _, aux = forward(params, batch["tokens"], cfg, rules,
                             mode="train")
    return causal_lm_loss(logits, batch["tokens"], rules) \
        + AUX_LOSS_COEF * aux

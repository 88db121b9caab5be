"""RecurrentGemma / Griffin hybrid (arXiv:2402.19427).

Block pattern 1:2 — every third residual block is local (windowed) MQA
attention, the others are recurrent blocks: linear-in → (GeLU gate branch ×
causal conv1d → RG-LRU branch) → linear-out.  Decode state is O(window) for
the attention blocks (ring-buffer KV) and O(1) for the recurrent blocks
(conv tail + LRU state).

Layers come in groups of 3 (rec, rec, attn), the reference's scan unit; the
``n_layers % 3`` leftover recurrent blocks are the tail.  The parameters are
an ``nn.Module`` in the reference's (in, out) layout, the forward pass a
Python loop over the groups.  With ``attention_impl="cuda"`` the recurrence
is the hand-written RG-LRU kernel, a prefill's local attention the
flash-attention kernel and a decode step's attention over the ring buffer
the decode-attention kernel (on CPU tensors their wrappers take the plain
versions); otherwise a decode step's attention is eager torch, as the
reference's is plain ``einsum``.  Decode writes the new token's k, v and
position into the ring buffer in place (as ``kvcache.update_layer`` does);
the recurrent state comes back in new tensors.

Over a ``"model"`` axis of more than one rank (``rules`` from ``rules_for``
on a mesh of ranks) the recurrent width splits as ``d_ff``: a rank holds
its channels of ``conv_w``, ``conv_b``, ``b_a``, ``b_x``, ``log_lambda``,
``gate_a`` and ``gate_x`` (columns), its rows of ``w_out`` (summed by
``reduce_from_model``), and of ``w_in`` = [z | y] its part of z *and* of y
(``BLOCKED``: ``models.api.blocked_specs``).  The conv runs on the rank's
z, so its tail stays local, and the gates, dense (w, w), take z gathered
whole (``gather_from_model``): one gather a recurrent block.  The RG-LRU
scan, its ``h`` state and the conv tail are the rank's channels.  The
attention block is the dense family's tensor-parallel attention
(``transformer.tp_qkv`` and ``tp_out``): with one KV head, k and v are
gathered whole, so the ring-buffer cache is whole on every rank and every
rank writes it alike.  The MLPs split d_ff (``mlp_apply``), the tied
embedding and head the vocab.

Where ``attn_k``'s spec splits the ring's slots over ``"model"`` (the
reference's ``shard_seq``, ``ring_run``), a rank holds a run of
``window / m`` consecutive slots of ``attn_k``, ``attn_v`` and
``slot_pos``: a prefill keeps that run of the ring it builds, and a decode
step writes the new token only where its slot ``pos % window`` falls in
the run, attends every query head to the run and combines the ranks'
partials by their lse.  The ring fills its slots in order and a row's ring
comes whole from its own prefill, so the valid slots of the whole ring are
always the first ``min(pos + 1, window)``, and a rank's a prefix of its
run: the kernel path takes the run as it lies with that length
(``decode_attention_seq_split``), the plain path masks the run by its own
``slot_pos``.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.dist import tensor_parallel as tp
from repro_torch.dist import ranks
from repro_torch.dist.sharding import constrain, model_split
from repro_torch.kernels.rg_lru import rg_lru, rg_lru_ref

from . import kvcache
from .attention import (
    combine_decode_partials,
    decode_attention,
    decode_attention_masked,
    decode_attention_seq_split,
    multihead_attention,
)
from .config import ModelConfig
from .layers import (
    apply_rope,
    causal_lm_loss,
    fan_in_init,
    init_device,
    mlp_apply,
    mlp_init,
    mlp_logical_axes,
    norm_init,
    normal_init,
    remat_call,
    rms_norm,
)
from .layers import remat_policy_of  # noqa: F401  (public, as the reference's)
from .transformer import (DecoderLayer, _embed, _heads, _logits, _params,
                          tp_out, tp_qkv)

LRU_C = 8.0
#: parameters the reference creates in f32 whatever ``cfg.dtype`` is
FLOAT32_PARAMS = ("log_lambda",)
#: leaves laid out as blocks end to end: name -> (dimension, blocks);
#: ``w_in`` is [z | y], and a rank holds its part of each
BLOCKED = {"w_in": (1, 2)}


class Group(nn.Module):
    """One (rec, rec, attn) group: ``rec1``, ``rec2``, ``attn``."""

    def __init__(self, tensors: dict):
        super().__init__()
        for name in ("rec1", "rec2", "attn"):
            setattr(self, name, DecoderLayer(tensors[name]))


class Griffin(nn.Module):
    """``embed`` (vocab, d_model, tied as the output head), ``groups``,
    ``tail`` (recurrent blocks) and ``final_norm``."""

    def __init__(self, embed: torch.Tensor, groups: list[dict],
                 tail: list[dict], final_norm: dict):
        super().__init__()
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.groups = nn.ModuleList(Group(g) for g in groups)
        self.tail = nn.ModuleList(DecoderLayer(t) for t in tail)
        self.final_norm = _params(final_norm)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _init_rec_block(generator: torch.Generator, cfg: ModelConfig,
                    device: torch.device) -> dict:
    dt = cfg.torch_dtype
    d, w = cfg.d_model, cfg.d_model  # lru width = d_model

    def zeros(n):
        return torch.zeros((n,), dtype=dt, device=device)

    return {
        "norm": norm_init(d, "rmsnorm", dt, device),
        "w_in": fan_in_init(generator, (d, 2 * w), dt, device),
        "conv_w": normal_init(generator, (cfg.conv_width, w), 0.1, dt, device),
        "conv_b": zeros(w),
        "gate_a": fan_in_init(generator, (w, w), dt, device),
        "b_a": zeros(w),
        "gate_x": fan_in_init(generator, (w, w), dt, device),
        "b_x": zeros(w),
        "log_lambda": normal_init(generator, (w,), 0.5, torch.float32, device),
        "w_out": fan_in_init(generator, (w, d), dt, device),
        "mlp_norm": norm_init(d, "rmsnorm", dt, device),
        "mlp": mlp_init(generator, d, cfg.d_ff, cfg.activation, dt, device),
    }


def _init_attn_block(generator: torch.Generator, cfg: ModelConfig,
                     device: torch.device) -> dict:
    dt = cfg.torch_dtype
    d = cfg.d_model
    return {
        "norm": norm_init(d, "rmsnorm", dt, device),
        "wq": fan_in_init(generator, (d, cfg.q_dim), dt, device),
        "wk": fan_in_init(generator, (d, cfg.kv_dim), dt, device),
        "wv": fan_in_init(generator, (d, cfg.kv_dim), dt, device),
        "wo": fan_in_init(generator, (cfg.q_dim, d), dt, device),
        "mlp_norm": norm_init(d, "rmsnorm", dt, device),
        "mlp": mlp_init(generator, d, cfg.d_ff, cfg.activation, dt, device),
    }


def _rec_axes(cfg: ModelConfig) -> dict:
    return {
        "norm": {"scale": ("d_model",)},
        "w_in": ("d_model", "d_ff"),
        "conv_w": (None, "d_ff"),
        "conv_b": ("d_ff",),
        "gate_a": ("d_model", "d_ff"),
        "b_a": ("d_ff",),
        "gate_x": ("d_model", "d_ff"),
        "b_x": ("d_ff",),
        "log_lambda": ("d_ff",),
        "w_out": ("d_ff", "d_model"),
        "mlp_norm": {"scale": ("d_model",)},
        "mlp": mlp_logical_axes(cfg.activation),
    }


def _attn_axes(cfg: ModelConfig) -> dict:
    return {
        "norm": {"scale": ("d_model",)},
        "wq": ("d_model", "heads"),
        "wk": ("d_model", "heads"),
        "wv": ("d_model", "heads"),
        "wo": ("heads", "d_model"),
        "mlp_norm": {"scale": ("d_model",)},
        "mlp": mlp_logical_axes(cfg.activation),
    }


def n_groups(cfg: ModelConfig) -> tuple[int, int]:
    """(number of (rec, rec, attn) groups, leftover recurrent blocks)."""
    period = cfg.attn_every
    return cfg.n_layers // period, cfg.n_layers % period


def init_params(generator: torch.Generator, cfg: ModelConfig,
                device: torch.device | str | None = None) -> Griffin:
    """Random parameters made on ``device`` (None: the GPU) from
    ``generator``, which must live on that device.  Tied embeddings."""
    device = init_device(generator, device)
    dt = cfg.torch_dtype
    g, tail = n_groups(cfg)
    embed = normal_init(generator, (cfg.vocab, cfg.d_model), 0.02, dt, device)
    groups = [{"rec1": _init_rec_block(generator, cfg, device),
               "rec2": _init_rec_block(generator, cfg, device),
               "attn": _init_attn_block(generator, cfg, device)}
              for _ in range(g)]
    tails = [_init_rec_block(generator, cfg, device) for _ in range(tail)]
    return Griffin(embed, groups, tails,
                   norm_init(cfg.d_model, "rmsnorm", dt, device))


def params_logical_axes(cfg: ModelConfig) -> dict:
    def stack(ax):
        if isinstance(ax, dict):
            return {k: stack(v) for k, v in ax.items()}
        return ("layers",) + ax

    _, tail = n_groups(cfg)
    return {
        "embed": ("vocab", "d_model"),
        "groups": stack({"rec1": _rec_axes(cfg), "rec2": _rec_axes(cfg),
                         "attn": _attn_axes(cfg)}),
        "tail": [_rec_axes(cfg) for _ in range(tail)],
        "final_norm": {"scale": ("d_model",)},
    }


# ---------------------------------------------------------------------------
# Decode state
# ---------------------------------------------------------------------------


def ring_run(cfg: ModelConfig, rules) -> tuple[int, int]:
    """(ranks, offset) of this rank's run of the ring's ``window`` slots
    under ``rules``: ``attn_k`` has the KV cache's axes, so its own spec
    splits the slots as ``kvcache.seq_run`` reads them (1 rank where it
    gives "model" to the KV heads), in runs of ``window / m``
    (``kvcache.local_len``: ``m`` must divide the window)."""
    return kvcache.seq_run(rules, kvcache.local_len(rules,
                                                    cfg.window or 2048))


def init_state(cfg: ModelConfig, batch: int,
               device: torch.device | str | None = None,
               rules=None) -> dict:
    """Zeros, and -1 (empty) slot positions, on ``device`` (None: the
    GPU); this rank's recurrent channels (and KV heads, where ``rules``
    split them, or its run of the ring's slots, ``ring_run``) over ranks
    of ``"model"``."""
    device = resolve_device(device)
    g, tail = n_groups(cfg)
    w = cfg.d_model // model_split(rules, "d_ff")
    cw = cfg.conv_width - 1
    win = kvcache.local_len(rules, cfg.window or 2048)

    def rec_state(lead):
        return {
            "conv": torch.zeros(lead + (batch, cw, w), dtype=cfg.torch_dtype,
                                device=device),
            "h": torch.zeros(lead + (batch, w), dtype=torch.float32,
                             device=device),
        }

    kv = (g, batch, cfg.n_kv_heads // model_split(rules, "kv_heads"), win,
          cfg.head_dim)
    return {
        "rec1": rec_state((g,)),
        "rec2": rec_state((g,)),
        "attn_k": torch.zeros(kv, dtype=cfg.torch_dtype, device=device),
        "attn_v": torch.zeros(kv, dtype=cfg.torch_dtype, device=device),
        "slot_pos": torch.full((g, batch, win), -1, dtype=torch.int32,
                               device=device),
        "tail": [rec_state(()) for _ in range(tail)],
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def state_logical_axes(cfg: ModelConfig) -> dict:
    _, tail = n_groups(cfg)
    rec = {"conv": ("layers", "batch", None, "d_ff"),
           "h": ("layers", "batch", "d_ff")}
    rec_tail = {"conv": ("batch", None, "d_ff"), "h": ("batch", "d_ff")}
    return {
        "rec1": dict(rec), "rec2": dict(rec),
        "attn_k": kvcache.KV_AXES, "attn_v": kvcache.KV_AXES,
        "slot_pos": ("layers", "batch", "kv_seq"),
        "tail": [dict(rec_tail) for _ in range(tail)],
        "pos": ("batch",),
    }


def state_specs(cfg: ModelConfig, rules, specs: dict) -> dict:
    """``specs`` (the reference's, from ``state_logical_axes``) with
    ``slot_pos``'s slots split as ``attn_k``'s are (``ring_run``): where
    the spec gives ``"model"`` to the KV heads, the ring's slots stay
    whole on every rank, and so do their positions
    (``models.api.state_specs``)."""
    specs["slot_pos"] = specs["slot_pos"][:2] + specs["attn_k"][3:4]
    return specs


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: torch.Tensor | None):
    """Depthwise causal conv along seq.  x (B,S,W); w (cw, W).  ``tail`` is
    the previous cw-1 inputs for decode; returns (y, new_tail)."""
    cw = w.shape[0]
    if tail is None:
        tail = torch.zeros((x.shape[0], cw - 1, x.shape[2]), dtype=x.dtype,
                           device=x.device)
    ext = torch.cat([tail.to(x.dtype), x], dim=1)  # (B, S+cw-1, W)
    s = x.shape[1]
    y = sum(ext[:, i:i + s, :] * w[i][None, None, :] for i in range(cw)) + b
    return y, ext[:, -(cw - 1):, :]


def _rec_block(lp, x: torch.Tensor, cfg: ModelConfig, st: dict | None,
               rules):
    """Recurrent residual block; ``st`` = {conv, h} or None (fresh state).
    Always returns (x, new_state) — callers in train mode discard it."""
    split = model_split(rules, "d_ff") > 1
    mesh = rules.mesh if split else None
    xn = rms_norm(x, lp.norm["scale"])
    if split:
        xn = tp.copy_to_model(xn, mesh)
    z, y = (xn @ lp.w_in).chunk(2, dim=-1)
    z = constrain(z, rules, ("batch", "seq", "d_ff"),
                  (None, None, cfg.d_model))
    z, new_conv = _causal_conv(z, lp.conv_w, lp.conv_b,
                               st["conv"] if st is not None else None)
    # the gates are dense (w, w): each rank's columns of them read all of z
    zg = tp.gather_from_model(z, -1, mesh) if split else z
    r = torch.sigmoid(zg @ lp.gate_a + lp.b_a).float()
    i = torch.sigmoid(zg @ lp.gate_x + lp.b_x)
    log_a = -LRU_C * F.softplus(lp.log_lambda) * r  # (B,S,W) ≤ 0
    gx = i * z
    core = rg_lru if cfg.attention_impl == "cuda" else rg_lru_ref
    h, h_final = core(log_a.to(gx.dtype), gx,
                      st["h"] if st is not None else None, return_state=True)
    out = (h * F.gelu(y, approximate="tanh")) @ lp.w_out
    x = x + (tp.reduce_from_model(out, mesh) if split else out)
    xn = rms_norm(x, lp.mlp_norm["scale"])
    x = x + mlp_apply(lp.mlp, xn, cfg.activation, rules)
    return x, {"conv": new_conv, "h": h_final}


def _qkv(lp, xn: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
         rules, whole_q: bool = False):
    """q (B, S, HQ, D) and k, v (B, S, HKV, D), q and k rotated, with the
    columns this rank keeps of the output and the KV heads its queries
    attend to (``transformer.tp_qkv``; ``whole_q``: every query head)."""
    q, k, v, cols, mine = tp_qkv(lp, xn, cfg, rules, whole_q=whole_q)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v, cols, mine)


def _attn_block_train(lp, x: torch.Tensor, cfg: ModelConfig,
                      positions: torch.Tensor, rules, want_cache=False,
                      run: tuple[int, int] = kvcache.WHOLE):
    """The block over a whole sequence; with ``want_cache`` (a prefill)
    also the ring cache of its last ``window`` positions, this rank's
    ``run`` of its slots (``ring_run``)."""
    b, s, _ = x.shape
    win = cfg.window or 2048
    q, k, v, cols, mine = _qkv(lp, rms_norm(x, lp.norm["scale"]), cfg,
                               positions, rules)
    q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    out = multihead_attention(q, _heads(k, mine), _heads(v, mine),
                              impl=cfg.attention_impl, causal=True,
                              window=cfg.window)
    out = out.transpose(1, 2).reshape(b, s, q.shape[1] * cfg.head_dim)
    x = x + tp_out(lp, out, cfg, rules, cols)
    xn = rms_norm(x, lp.mlp_norm["scale"])
    x = x + mlp_apply(lp.mlp, xn, cfg.activation, rules)
    if not want_cache:
        return x, None
    return x, ring_cache(k.to(x.dtype), v.to(x.dtype), positions, win, run)


def ring_cache(k: torch.Tensor, v: torch.Tensor, positions: torch.Tensor,
               win: int, run: tuple[int, int] = kvcache.WHOLE) -> dict:
    """The ring-buffer cache a prefill leaves: the last ``win`` of the
    sequence's k and v (B, KV, S, D) at slots ``position % win`` and their
    positions in ``slot_pos`` (-1: empty), this rank's ``run`` of the
    slots (``ring_run``)."""
    b, hkv, s, d = k.shape
    w_eff = min(win, s)
    slots = torch.arange(s - w_eff, s, device=k.device) % win
    k_cache = torch.zeros((b, hkv, win, d), dtype=k.dtype, device=k.device)
    v_cache = torch.zeros_like(k_cache)
    k_cache[:, :, slots, :] = k[:, :, s - w_eff:, :]
    v_cache[:, :, slots, :] = v[:, :, s - w_eff:, :]
    slot_pos = torch.full((b, win), -1, dtype=torch.int32, device=k.device)
    slot_pos[:, slots] = positions[:, s - w_eff:].to(torch.int32)
    m, offset = run
    if m > 1:
        mine = slice(offset, offset + win // m)
        k_cache, v_cache = k_cache[:, :, mine], v_cache[:, :, mine]
        slot_pos = slot_pos[:, mine]
    return {"k": k_cache, "v": v_cache, "slot_pos": slot_pos}


def ring_write(st: dict, k: torch.Tensor, v: torch.Tensor,
               pos: torch.Tensor, win: int,
               run: tuple[int, int] = kvcache.WHOLE) -> None:
    """One token's k and v (B, KV, 1, D) and position ``pos`` (B,) into
    slot ``pos % win`` of the ring ``st`` (``k``, ``v``, ``slot_pos``), in
    place; on a rank's ``run`` of the slots, only where the slot falls in
    it (``kvcache.update_layer``'s write: no host waits)."""
    slots = kvcache._slots(pos % win, k.shape[0], 1, st["k"].shape[2], run)
    kvcache._write(st["k"], k, slots)
    kvcache._write(st["v"], v, slots)
    kvcache._write(st["slot_pos"][:, None], pos[:, None, None], slots)


def _attn_block_decode(lp, x: torch.Tensor, cfg: ModelConfig,
                       pos: torch.Tensor, st: dict, rules,
                       run: tuple[int, int] = kvcache.WHOLE):
    """One-token local attention against the ring-buffer window cache.

    The cache holds the last ``window`` tokens; the new entry overwrites
    slot ``pos % window`` in place, and ``slot_pos`` records each slot's
    absolute position (−1 = empty) for masking.  Where ``run``
    (``ring_run``) splits the slots, ``st`` holds this rank's run of them:
    the entry is written only where its slot falls in the run (no host
    waits: ``kvcache.update_layer``'s write), every query head attends to
    the run, and the ranks' partials are combined by their lse.
    """
    b = x.shape[0]  # one token a row
    win = cfg.window or 2048
    split = run[0] > 1
    q, k, v, cols, mine = _qkv(lp, rms_norm(x, lp.norm["scale"]), cfg,
                               pos[:, None], rules, whole_q=split)
    ring_write(st, k.transpose(1, 2), v.transpose(1, 2), pos, win, run)
    k_cache, v_cache, slot_pos = st["k"], st["v"], st["slot_pos"]
    kc, vc = _heads(k_cache, mine), _heads(v_cache, mine)

    scale = 1.0 / math.sqrt(cfg.head_dim)
    hq = q.shape[2]
    if cfg.attention_impl == "cuda":
        # The ring fills its slots in order and a slot's cache comes whole
        # from its own prefill, so the valid slots (0 <= slot_pos <= pos)
        # are always the first min(pos + 1, window), and a rank's the
        # first of its run: the kernel takes the cache as it lies, its kv
        # heads shared by the group, and reads no slot past them.
        kv_len = torch.clamp(pos + 1, max=win).to(torch.int32)
        if split:
            out = decode_attention_seq_split(
                q[:, 0], kc, vc, kv_len, run[1], tp.MODEL, mesh=rules.mesh,
                impl="cuda", scale=scale)
        else:
            out = decode_attention(q[:, 0], kc, vc, kv_len, impl="cuda",
                                   scale=scale)
    else:
        valid = (slot_pos >= 0) & (slot_pos <= pos[:, None])
        out, lse = decode_attention_masked(q[:, 0], kc, vc, valid,
                                           scale=scale)
        if split:
            with ranks.use_mesh(rules.mesh):
                out = combine_decode_partials(out, lse, tp.MODEL)
    x = x + tp_out(lp, out.reshape(b, 1, hq * cfg.head_dim), cfg, rules,
                   cols)
    xn = rms_norm(x, lp.mlp_norm["scale"])
    x = x + mlp_apply(lp.mlp, xn, cfg.activation, rules)
    return x, {"k": k_cache, "v": v_cache, "slot_pos": slot_pos}


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _stack_rec(states: list[dict]) -> dict:
    return {name: torch.stack([st[name] for st in states])
            for name in ("conv", "h")}


def _group_fn(cfg: ModelConfig, rules, x: torch.Tensor, gp: Group,
              positions: torch.Tensor, want_cache: bool,
              run: tuple[int, int] = kvcache.WHOLE):
    """One (rec, rec, attn) group over a whole sequence from fresh state:
    (x, both recurrent blocks' final states, the attention block's ring
    cache, this rank's ``run`` of its slots, or None)."""
    x, n1 = _rec_block(gp.rec1, x, cfg, None, rules)
    x, n2 = _rec_block(gp.rec2, x, cfg, None, rules)
    x, cache = _attn_block_train(gp.attn, x, cfg, positions, rules,
                                 want_cache=want_cache, run=run)
    return x, n1, n2, cache


def forward(
    params: Griffin,
    tokens: torch.Tensor,  # (B, S) int — or (B, S, D) pre-embedded
    cfg: ModelConfig,
    rules=None,
    mode: str = "train",  # train | prefill | decode
    state: dict | None = None,
    extra_embeds=None,
):
    """Logits (B, S, vocab), or (B, 1, vocab) in decode mode, and the new
    state (a prefill makes a fresh one; None in train mode).  Where
    ``rules`` split the vocab over more than one rank of ``"model"``, train
    logits are this rank's slice of the vocab and the others gathered
    whole."""
    x = _embed(params, tokens, rules) if tokens.ndim == 2 else tokens
    # The scale rounded to x's type first, as the reference's
    # jnp.asarray(sqrt(d), x.dtype) (a Python float: no copy to the device).
    x = x * float(torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype))
    b, s, _ = x.shape
    steps = torch.arange(s, device=x.device, dtype=torch.int32)
    if mode == "decode":
        positions = state["pos"][:, None] + steps[None, :]
    else:
        positions = steps[None, :].expand(b, s)

    new_state = None
    run = ring_run(cfg, rules)
    if state is not None and mode == "decode":
        rec1, rec2 = [], []
        for gi, gp in enumerate(params.groups):
            x, n1 = _rec_block(gp.rec1, x, cfg,
                               {n: t[gi] for n, t in state["rec1"].items()},
                               rules)
            x, n2 = _rec_block(gp.rec2, x, cfg,
                               {n: t[gi] for n, t in state["rec2"].items()},
                               rules)
            x, _ = _attn_block_decode(
                gp.attn, x, cfg, state["pos"],
                {"k": state["attn_k"][gi], "v": state["attn_v"][gi],
                 "slot_pos": state["slot_pos"][gi]}, rules, run)
            rec1.append(n1)
            rec2.append(n2)
        new_state = dict(state)
        if rec1:
            new_state["rec1"], new_state["rec2"] = (_stack_rec(rec1),
                                                    _stack_rec(rec2))
        tail_states = []
        for lp, st in zip(params.tail, state["tail"]):
            x, nst = _rec_block(lp, x, cfg, st, rules)
            tail_states.append(nst)
        new_state["tail"] = tail_states
        new_state["pos"] = state["pos"] + s
    else:
        want = mode == "prefill"
        rec1, rec2, caches = [], [], []
        for gp in params.groups:
            x, n1, n2, cache = remat_call(cfg, mode, _group_fn, cfg, rules, x,
                                          gp, positions, want, run)
            rec1.append(n1)
            rec2.append(n2)
            caches.append(cache)
        tail_states = []
        for lp in params.tail:
            x, nst = _rec_block(lp, x, cfg, None, rules)
            tail_states.append(nst)
        if want:
            if caches:
                new_state = {
                    "rec1": _stack_rec(rec1), "rec2": _stack_rec(rec2),
                    "attn_k": torch.stack([c["k"] for c in caches]),
                    "attn_v": torch.stack([c["v"] for c in caches]),
                    "slot_pos": torch.stack([c["slot_pos"] for c in caches]),
                }
            else:
                new_state = init_state(cfg, b, x.device, rules)
            new_state["tail"] = tail_states
            new_state["pos"] = torch.full((b,), s, dtype=torch.int32,
                                          device=x.device)

    return _logits(params, x, cfg, rules, mode), new_state  # tied


def train_loss(params: Griffin, batch: dict, cfg: ModelConfig,
               rules=None) -> torch.Tensor:
    """The forward loss.  It differentiates through the plain scan and
    attention (``attention_impl`` "xla"), as the reference trains: the
    RG-LRU and flash-attention kernels have no backward."""
    logits, _ = forward(params, batch["tokens"], cfg, rules, mode="train")
    return causal_lm_loss(logits, batch["tokens"], rules)

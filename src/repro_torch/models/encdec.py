"""Whisper-style encoder-decoder (arXiv:2212.04356): the audio backbone.

The conv mel-spectrogram frontend is a stub, as in the reference: the
caller hands over precomputed frame embeddings (B, frames, D), the output
of Whisper's two conv layers, and the encoder adds sinusoidal positions.
The transformer backbone is faithful: pre-LN, GELU MLPs, learned decoder
positions, causal decoder self-attention and cross-attention to the
encoder output.

Serving: ``prefill`` encodes the frames once, runs the decoder over the
prompt and keeps each decoder layer's self-attention K and V and its
cross-attention K and V of the encoder output; ``decode_step`` runs one
token against both caches.  With ``attention_impl="cuda"`` every attention
is a hand-written kernel: flash attention in the encoder (non-causal) and
in a prefill's decoder (causal self-attention, non-causal cross-attention),
decode attention twice a decoder layer in a step.  The reference's
``decode_step`` takes its plain decode attention whatever the config says;
this one takes ``cfg.attention_impl`` (ROADMAP Queue C).

The parameters are an ``EncDec`` module with the reference's layout
(``x @ W``); the passes are Python loops over the layers, and the caches'
buffers are written in place.

Over a ``"model"`` axis of more than one rank (``rules`` from ``rules_for``
on a mesh of ranks) every attention is the dense family's tensor-parallel
attention (``transformer.tp_qkv`` and ``tp_out``: q, k and v column-split
by heads, ``wo`` row-split and summed by ``reduce_from_model``); a
cross-attention's ``wk`` and ``wv`` are column-split too, with the
encoder's output passing ``copy_to_model`` at each layer's
cross-attention.  The MLPs split d_ff (``mlp_apply``); the self- and
cross-attention caches hold the rank's KV heads where the rules split
them.  The embedding and the tied head split by vocab where it divides
(whisper-medium's 51865 does not: there they stay whole).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from repro_torch.device import resolve_device
from repro_torch.dist.sharding import constrain, model_split

from . import kvcache
from .attention import decode_attention, multihead_attention
from .config import ModelConfig
from .layers import (
    apply_norm,
    fan_in_init,
    init_device,
    mlp_apply,
    mlp_init,
    mlp_logical_axes,
    norm_init,
    normal_init,
    remat_call,
    softmax_xent,
)
from .layers import remat_policy_of  # noqa: F401  (public, as the reference's)
from .transformer import (DecoderLayer, _embed, _heads as _kv_of, _params,
                          kv_heads_attended, lm_head, seq_split_decode,
                          tp_out, tp_q, tp_qkv)

MAX_DECODE_LEN_AXIS = "kv_seq"
#: rows of the learned decoder positions
DEC_POSITIONS = 32768 + 8


class EncDec(nn.Module):
    """``embed`` (vocab, d_model; also the tied output head), ``dec_pos``
    (``DEC_POSITIONS``, d_model), ``enc_layers`` (``norm1``, ``attn``,
    ``norm2``, ``mlp``), ``enc_norm``, ``dec_layers`` (``norm1``,
    ``self_attn``, ``norm_x``, ``cross_attn``, ``norm2``, ``mlp``) and
    ``dec_norm``."""

    def __init__(self, embed: torch.Tensor, dec_pos: torch.Tensor,
                 enc_layers: list[dict], enc_norm: dict,
                 dec_layers: list[dict], dec_norm: dict):
        super().__init__()
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.dec_pos = nn.Parameter(dec_pos, requires_grad=False)
        self.enc_layers = nn.ModuleList(DecoderLayer(t) for t in enc_layers)
        self.enc_norm = _params(enc_norm)
        self.dec_layers = nn.ModuleList(DecoderLayer(t) for t in dec_layers)
        self.dec_norm = _params(dec_norm)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _attn_init(generator, cfg, device) -> dict:
    dt = cfg.torch_dtype
    return {
        "wq": fan_in_init(generator, (cfg.d_model, cfg.q_dim), dt, device),
        "wk": fan_in_init(generator, (cfg.d_model, cfg.kv_dim), dt, device),
        "wv": fan_in_init(generator, (cfg.d_model, cfg.kv_dim), dt, device),
        "wo": fan_in_init(generator, (cfg.q_dim, cfg.d_model), dt, device),
    }


def _attn_axes() -> dict:
    return {
        "wq": ("d_model", "heads"),
        "wk": ("d_model", "heads"),
        "wv": ("d_model", "heads"),
        "wo": ("heads", "d_model"),
    }


def init_enc_layer(generator: torch.Generator, cfg: ModelConfig,
                   device: torch.device | str | None = None) -> dict:
    """One encoder layer's weights on ``device`` (None: the
    generator's)."""
    device = device if device is not None else generator.device
    dt = cfg.torch_dtype
    return {
        "norm1": norm_init(cfg.d_model, cfg.norm, dt, device),
        "attn": _attn_init(generator, cfg, device),
        "norm2": norm_init(cfg.d_model, cfg.norm, dt, device),
        "mlp": mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.activation, dt,
                        device),
    }


def init_dec_layer(generator: torch.Generator, cfg: ModelConfig,
                   device: torch.device | str | None = None) -> dict:
    """One decoder layer's weights on ``device`` (None: the
    generator's)."""
    device = device if device is not None else generator.device
    dt = cfg.torch_dtype
    return {
        "norm1": norm_init(cfg.d_model, cfg.norm, dt, device),
        "self_attn": _attn_init(generator, cfg, device),
        "norm_x": norm_init(cfg.d_model, cfg.norm, dt, device),
        "cross_attn": _attn_init(generator, cfg, device),
        "norm2": norm_init(cfg.d_model, cfg.norm, dt, device),
        "mlp": mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.activation, dt,
                        device),
    }


def init_params(generator: torch.Generator, cfg: ModelConfig,
                device: torch.device | str | None = None) -> EncDec:
    """Random parameters made on ``device`` (None: the GPU) from
    ``generator``, which must live on that device.  The output head is
    tied to ``embed``, as Whisper's is."""
    device = init_device(generator, device)
    dt = cfg.torch_dtype
    return EncDec(
        normal_init(generator, (cfg.vocab, cfg.d_model), 0.02, dt, device),
        normal_init(generator, (DEC_POSITIONS, cfg.d_model), 0.01, dt,
                    device),
        [init_enc_layer(generator, cfg, device)
         for _ in range(cfg.n_enc_layers)],
        norm_init(cfg.d_model, cfg.norm, dt, device),
        [init_dec_layer(generator, cfg, device)
         for _ in range(cfg.n_layers)],
        norm_init(cfg.d_model, cfg.norm, dt, device))


def params_logical_axes(cfg: ModelConfig) -> dict:
    norm_ax = (
        {"scale": ("d_model",)}
        if cfg.norm == "rmsnorm"
        else {"scale": ("d_model",), "bias": ("d_model",)}
    )

    def stack(ax):
        if isinstance(ax, dict):
            return {k: stack(v) for k, v in ax.items()}
        return ("layers",) + ax

    enc = {"norm1": dict(norm_ax), "attn": _attn_axes(),
           "norm2": dict(norm_ax),
           "mlp": mlp_logical_axes(cfg.activation)}
    dec = {"norm1": dict(norm_ax), "self_attn": _attn_axes(),
           "norm_x": dict(norm_ax), "cross_attn": _attn_axes(),
           "norm2": dict(norm_ax),
           "mlp": mlp_logical_axes(cfg.activation)}
    return {
        "embed": ("vocab", "d_model"),
        "dec_pos": (None, "d_model"),
        "enc_layers": stack(enc),
        "enc_norm": dict(norm_ax),
        "dec_layers": stack(dec),
        "dec_norm": dict(norm_ax),
    }


# ---------------------------------------------------------------------------
# Attention helpers
# ---------------------------------------------------------------------------


def _mha(ap, xq, xkv, cfg, causal, rules, q_offset=0):
    """Attention of ``xq`` to ``xkv`` through ``ap``'s weights, projected
    by ``wo``; and the k and v (B, KV heads, T, head_dim) a cache keeps."""
    b, s, _ = xq.shape
    q, k, v, cols, mine = tp_qkv(ap, xq, cfg, rules,
                                 None if xkv is xq else xkv)
    q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    out = multihead_attention(q, _kv_of(k, mine), _kv_of(v, mine),
                              impl=cfg.attention_impl, causal=causal,
                              q_offset=q_offset)
    out = out.transpose(1, 2).reshape(b, s, q.shape[1] * cfg.head_dim)
    return tp_out(ap, out, cfg, rules, cols), k, v


def _decode_impl(cfg: ModelConfig) -> str:
    return "cuda" if cfg.attention_impl == "cuda" else "xla"


# ---------------------------------------------------------------------------
# Encoder / decoder
# ---------------------------------------------------------------------------


def _sinusoids(frames: int, d: int, device) -> torch.Tensor:
    """Whisper's fixed encoder positions (frames, d) in f32: sin of each
    frequency, then cos."""
    pos = torch.arange(frames, device=device, dtype=torch.float32)
    inv = torch.exp(-torch.arange(0, d, 2, device=device,
                                  dtype=torch.float32) / d
                    * math.log(10000.0))
    ang = pos[:, None] * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def encode(params: EncDec, frames: torch.Tensor, cfg: ModelConfig,
           rules=None) -> torch.Tensor:
    """frames: (B, F, D) precomputed conv-frontend output (stub).  Each
    layer runs under remat where ``cfg.remat`` and autograd records, as the
    reference wraps the encoder's and decoder's layers whatever the mode."""
    x = frames + _sinusoids(frames.shape[1], cfg.d_model,
                            frames.device)[None].to(frames.dtype)
    for lp in params.enc_layers:
        x = remat_call(cfg, "train", _encoder_layer, lp, x, cfg, rules)
    return apply_norm(x, params.enc_norm, cfg.norm)


def _encoder_layer(lp, x, cfg, rules):
    h = apply_norm(x, lp.norm1, cfg.norm)
    x = x + _mha(lp.attn, h, h, cfg, causal=False, rules=rules)[0]
    h = apply_norm(x, lp.norm2, cfg.norm)
    x = x + mlp_apply(lp.mlp, h, cfg.activation, rules)
    return constrain(x, rules, ("batch", "frames", "d_model"))


def _decoder_layer(lp, x, enc_out, cfg, rules):
    """One decoder layer over a whole sequence (teacher forcing)."""
    h = apply_norm(x, lp.norm1, cfg.norm)
    x = x + _mha(lp.self_attn, h, h, cfg, causal=True, rules=rules)[0]
    h = apply_norm(x, lp.norm_x, cfg.norm)
    x = x + _mha(lp.cross_attn, h, enc_out, cfg, causal=False,
                 rules=rules)[0]
    h = apply_norm(x, lp.norm2, cfg.norm)
    x = x + mlp_apply(lp.mlp, h, cfg.activation, rules)
    return constrain(x, rules, ("batch", "seq", "d_model"))


def decode_train(params: EncDec, tokens: torch.Tensor, enc_out: torch.Tensor,
                 cfg: ModelConfig, rules=None,
                 q_offset: int = 0) -> torch.Tensor:
    """Logits of every position (this rank's slice of the vocab where
    ``rules`` split it)."""
    x = _embed(params, tokens, rules)
    s = tokens.shape[1]
    x = x + params.dec_pos[q_offset:q_offset + s][None]
    for lp in params.dec_layers:
        x = remat_call(cfg, "train", _decoder_layer, lp, x, enc_out, cfg,
                       rules)
    x = apply_norm(x, params.dec_norm, cfg.norm)
    return lm_head(x, params.embed.T, cfg, rules, "train")


def train_loss(params: EncDec, batch: dict, cfg: ModelConfig,
               rules=None) -> torch.Tensor:
    enc_out = encode(params, batch["frames"], cfg, rules)
    logits = decode_train(params, batch["tokens"], enc_out, cfg, rules)
    return softmax_xent(logits[:, :-1, :], batch["tokens"][:, 1:],
                        rules=rules)


# ---------------------------------------------------------------------------
# Serving: prefill + single-token decode with self/cross KV caches
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: torch.device | str | None = None,
               rules=None) -> dict:
    """Zeros on ``device`` (None: the GPU): the decoder's self-attention
    K and V up to ``max_len`` positions and its cross-attention K and V of
    ``cfg.enc_frames`` frames, (L, B, KV, T, head_dim) each; this rank's
    KV heads where ``rules`` split them over ranks of ``"model"``, or its
    run of the self-attention cache's positions where they split its
    sequence (``kvcache.seq_run``; the frames are never split)."""
    device = resolve_device(device)
    L, dt = cfg.n_layers, cfg.torch_dtype
    kv = cfg.n_kv_heads // model_split(rules, "kv_heads")
    self_shape = (L, batch, kv, kvcache.local_len(rules, max_len),
                  cfg.head_dim)
    cross_shape = (L, batch, kv, cfg.enc_frames, cfg.head_dim)
    return {
        "self_k": torch.zeros(self_shape, dtype=dt, device=device),
        "self_v": torch.zeros(self_shape, dtype=dt, device=device),
        "cross_k": torch.zeros(cross_shape, dtype=dt, device=device),
        "cross_v": torch.zeros(cross_shape, dtype=dt, device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def cache_logical_axes(cfg: ModelConfig) -> dict:
    kv = kvcache.KV_AXES
    xkv = ("layers", "batch", "kv_heads", "frames", "head_dim")
    return {"self_k": kv, "self_v": kv, "cross_k": xkv, "cross_v": xkv,
            "pos": ("batch",)}


def _write_rows(buf: torch.Tensor, val: torch.Tensor,
                pos: torch.Tensor, run=kvcache.WHOLE) -> None:
    """``buf[b, :, pos[b]:pos[b] + S] = val[b]`` for every row, the start
    clamped as ``dynamic_update_slice`` clamps it (on a rank's ``run`` of a
    sequence split by the rules, ``kvcache.seq_run``, the tokens that fall
    in it); buf (B, KV, T, D), val (B, KV, S, D)."""
    b, _, s, _ = val.shape
    kvcache._write(buf, val, kvcache._slots(pos, b, s, buf.shape[2], run))


def _prefill_hidden(params: EncDec, tokens: torch.Tensor,
                   frames: torch.Tensor, cfg: ModelConfig, cache: dict,
                   rules=None) -> tuple[torch.Tensor, dict]:
    """``prefill`` up to the decoder's final norm: the hidden states of
    every prompt position (B, S, D) and the cache."""
    enc_out = encode(params, frames, cfg, rules)
    b, s = tokens.shape
    x = _embed(params, tokens, rules) + params.dec_pos[:s][None]
    start = torch.zeros((b,), dtype=torch.int32, device=x.device)
    run = kvcache.seq_run(rules, cache["self_k"].shape[3])
    for i, lp in enumerate(params.dec_layers):
        h = apply_norm(x, lp.norm1, cfg.norm)
        out, k, v = _mha(lp.self_attn, h, h, cfg, causal=True, rules=rules)
        _write_rows(cache["self_k"][i], k, start, run)
        _write_rows(cache["self_v"][i], v, start, run)
        x = x + out
        h = apply_norm(x, lp.norm_x, cfg.norm)
        out, k, v = _mha(lp.cross_attn, h, enc_out, cfg, causal=False,
                         rules=rules)
        cache["cross_k"][i].copy_(k)
        cache["cross_v"][i].copy_(v)
        x = x + out
        h = apply_norm(x, lp.norm2, cfg.norm)
        x = x + mlp_apply(lp.mlp, h, cfg.activation, rules)
    new_cache = dict(cache)
    new_cache["pos"] = cache["pos"] + s
    return apply_norm(x, params.dec_norm, cfg.norm), new_cache


def prefill(params: EncDec, tokens: torch.Tensor, frames: torch.Tensor,
            cfg: ModelConfig, cache: dict, rules=None):
    """Run the encoder and the teacher-forced decoder over the prompt,
    filling the self-attention cache and each layer's cross-attention K
    and V.  Returns the last position's logits (B, 1, V) and the cache."""
    x, new_cache = _prefill_hidden(params, tokens, frames, cfg, cache, rules)
    return lm_head(x[:, -1:, :], params.embed.T, cfg, rules, "prefill"), \
        new_cache


def decode_step(params: EncDec, token: torch.Tensor, cfg: ModelConfig,
                cache: dict, rules=None):
    """token: (B, 1) -> next-token logits (B, 1, V), updated cache."""
    b = token.shape[0]
    pos = cache["pos"]
    x = _embed(params, token, rules) + params.dec_pos[pos.long()][:, None, :]
    impl = _decode_impl(cfg)
    n_frames = torch.full((b,), cache["cross_k"].shape[3],
                          dtype=torch.int32, device=x.device)
    run = kvcache.seq_run(rules, cache["self_k"].shape[3])
    for i, lp in enumerate(params.dec_layers):
        sk, sv = cache["self_k"][i], cache["self_v"][i]
        h = apply_norm(x, lp.norm1, cfg.norm)
        q, k, v, cols, mine = tp_qkv(lp.self_attn, h, cfg, rules,
                                     whole_q=run[0] > 1)
        _write_rows(sk, k.transpose(1, 2), pos, run)
        _write_rows(sv, v.transpose(1, 2), pos, run)
        hq = q.shape[2]
        if run[0] > 1:
            attn = seq_split_decode(q[:, 0], sk, sv, pos + 1, run[1], cfg,
                                    rules)
        else:
            attn = decode_attention(q[:, 0], _kv_of(sk, mine),
                                    _kv_of(sv, mine), pos + 1, impl=impl)
            attn = attn.reshape(b, 1, hq * cfg.head_dim)
        x = x + tp_out(lp.self_attn, attn, cfg, rules, cols)
        h = apply_norm(x, lp.norm_x, cfg.norm)
        qx, cols = tp_q(lp.cross_attn, h, cfg, rules)
        hq = qx.shape[2]
        xk, xv = cache["cross_k"][i], cache["cross_v"][i]
        mine = kv_heads_attended(cfg, hq, xk.shape[1], rules)
        xattn = decode_attention(qx[:, 0], _kv_of(xk, mine),
                                 _kv_of(xv, mine), n_frames, impl=impl)
        x = x + tp_out(lp.cross_attn,
                       xattn.reshape(b, 1, hq * cfg.head_dim), cfg, rules,
                       cols)
        h = apply_norm(x, lp.norm2, cfg.norm)
        x = x + mlp_apply(lp.mlp, h, cfg.activation, rules)
    x = apply_norm(x, params.dec_norm, cfg.norm)
    new_cache = dict(cache)
    new_cache["pos"] = pos + 1
    return lm_head(x, params.embed.T, cfg, rules, "decode"), new_cache

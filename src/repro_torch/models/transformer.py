"""Dense decoder-only transformer (phi3 / gemma / stablelm / qwen families,
and the InternVL backbone).

GQA/MQA attention with RoPE, SwiGLU/GeGLU MLPs, RMSNorm or LayerNorm,
optional QKV bias (qwen).  The parameters are an ``nn.Module``: a
``DecoderLayer`` per layer in an ``nn.ModuleList``, in place of the
reference's layer-stacked pytree that ``lax.scan`` walks, with the
reference's weight layout (``x @ W``, W of shape (in, out)), so that
carrying weights across is a split along the reference's layer axis.  The
forward pass is a Python loop over the layers, run eagerly.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from repro_torch.dist.sharding import constrain

from . import kvcache
from .attention import (
    decode_attention,
    decode_attention_quant,
    multihead_attention,
)
from .config import ModelConfig
from .layers import (
    apply_norm,
    apply_rope_tables,
    causal_lm_loss,
    fan_in_init,
    init_device,
    mlp_apply,
    mlp_init,
    mlp_logical_axes,
    norm_init,
    normal_init,
    remat_call,
    rope_tables,
)
from .layers import remat_policy_of  # noqa: F401  (public, as the reference's)

# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _params(tensors: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                             for k, v in tensors.items()})


class DecoderLayer(nn.Module):
    """One layer's weights: ``attn_norm``, ``wq``/``wk``/``wv``/``wo``
    (and ``bq``/``bk``/``bv`` with a QKV bias), ``mlp_norm``, ``mlp``."""

    def __init__(self, tensors: dict):
        super().__init__()
        for name, value in tensors.items():
            if isinstance(value, dict):
                setattr(self, name, _params(value))
            else:
                setattr(self, name, nn.Parameter(value, requires_grad=False))


class Transformer(nn.Module):
    """``embed`` (vocab, d_model), ``layers``, ``final_norm`` and, unless
    the embeddings are tied, ``lm_head`` (d_model, vocab)."""

    def __init__(self, embed: torch.Tensor, layers: list[dict],
                 final_norm: dict, lm_head: torch.Tensor | None = None):
        super().__init__()
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.layers = nn.ModuleList(DecoderLayer(t) for t in layers)
        self.final_norm = _params(final_norm)
        if lm_head is not None:
            self.lm_head = nn.Parameter(lm_head, requires_grad=False)


def init_layer(generator: torch.Generator, cfg: ModelConfig,
               device: torch.device) -> dict:
    dt = cfg.torch_dtype
    p = {
        "attn_norm": norm_init(cfg.d_model, cfg.norm, dt, device),
        "wq": fan_in_init(generator, (cfg.d_model, cfg.q_dim), dt, device),
        "wk": fan_in_init(generator, (cfg.d_model, cfg.kv_dim), dt, device),
        "wv": fan_in_init(generator, (cfg.d_model, cfg.kv_dim), dt, device),
        "wo": fan_in_init(generator, (cfg.q_dim, cfg.d_model), dt, device),
        "mlp_norm": norm_init(cfg.d_model, cfg.norm, dt, device),
        "mlp": mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.activation, dt,
                        device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((cfg.q_dim,), dtype=dt, device=device)
        p["bk"] = torch.zeros((cfg.kv_dim,), dtype=dt, device=device)
        p["bv"] = torch.zeros((cfg.kv_dim,), dtype=dt, device=device)
    return p


def layer_logical_axes(cfg: ModelConfig) -> dict:
    norm_ax = (
        {"scale": ("d_model",)}
        if cfg.norm == "rmsnorm"
        else {"scale": ("d_model",), "bias": ("d_model",)}
    )
    p = {
        "attn_norm": dict(norm_ax),
        "wq": ("d_model", "heads"),
        "wk": ("d_model", "heads"),
        "wv": ("d_model", "heads"),
        "wo": ("heads", "d_model"),
        "mlp_norm": dict(norm_ax),
        "mlp": mlp_logical_axes(cfg.activation),
    }
    if cfg.qkv_bias:
        p["bq"] = ("heads",)
        p["bk"] = ("heads",)
        p["bv"] = ("heads",)
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
    def stack(ax):
        if isinstance(ax, dict):
            return {k: stack(v) for k, v in ax.items()}
        return ("layers",) + ax

    p = {
        "embed": ("vocab", "d_model"),
        "layers": stack(layer_logical_axes(cfg)),
        "final_norm": (
            {"scale": ("d_model",)}
            if cfg.norm == "rmsnorm"
            else {"scale": ("d_model",), "bias": ("d_model",)}
        ),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = ("d_model", "vocab")
    return p


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _attention_block(
    lp: DecoderLayer,
    x: torch.Tensor,  # (B, S, D)
    cfg: ModelConfig,
    rules,
    positions: torch.Tensor,  # (B, S)
    mode: str,
    cache_l: dict | None,
    window: int | None = None,
    rope: tuple[torch.Tensor, torch.Tensor] | None = None,
):
    """``rope``: the forward pass's ``rope_tables`` for ``positions``
    (made here when not given)."""
    b, s, _ = x.shape
    h = apply_norm(x, lp.attn_norm, cfg.norm)
    q = h @ lp.wq
    k = h @ lp.wk
    v = h @ lp.wv
    if cfg.qkv_bias:
        q, k, v = q + lp.bq, k + lp.bk, v + lp.bv
    q = constrain(q, rules, ("batch", "seq", "heads"))
    k = constrain(k, rules, ("batch", "seq", "heads"))
    v = constrain(v, rules, ("batch", "seq", "heads"))
    q = q.reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = k.reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    if rope is None:
        rope = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    q = apply_rope_tables(q, *rope)
    k = apply_rope_tables(k, *rope)
    q = q.transpose(1, 2)  # (B, H, S, D)
    k = k.transpose(1, 2)
    v = v.transpose(1, 2)

    new_cache_l = None
    if mode == "decode":
        assert cache_l is not None
        new_cache_l = kvcache.update_layer(cfg, cache_l, k, v, positions[:, 0])
        kv_len = positions[:, 0] + 1
        if cfg.kv_quant and cfg.kv_fused and window is None:
            # Attend on the int8 cache directly: the scales factor out of
            # both dots, so the cache is read once, in int8.
            out = decode_attention_quant(
                q[:, :, 0],
                new_cache_l["k_q"], new_cache_l["k_s"],
                new_cache_l["v_q"], new_cache_l["v_s"],
                kv_len,
            )
            out = out[:, :, None, :].transpose(1, 2)
            out = out.reshape(b, s, cfg.q_dim)
            out = constrain(out, rules, ("batch", "seq", "heads"))
            return x + out @ lp.wo, new_cache_l
        k_full, v_full = kvcache.read_layer(cfg, new_cache_l)
        if window is not None:
            out = _windowed_decode(q[:, :, 0], k_full, v_full, kv_len, window)
        else:
            out = decode_attention(
                q[:, :, 0], k_full, v_full, kv_len,
                impl="cuda" if cfg.attention_impl == "cuda" else "xla",
            )
        out = out[:, :, None, :]  # (B, H, 1, D)
    else:
        if mode == "prefill" and cache_l is not None:
            new_cache_l = kvcache.update_layer(
                cfg, cache_l, k, v,
                torch.zeros((b,), dtype=torch.int32, device=x.device))
        out = multihead_attention(
            q, k, v,
            impl=cfg.attention_impl, causal=True, window=window,
        )
    out = out.transpose(1, 2).reshape(b, s, cfg.q_dim)
    out = constrain(out, rules, ("batch", "seq", "heads"))
    return x + out @ lp.wo, new_cache_l


def _windowed_decode(q, k, v, kv_len, window):
    """Decode attention with a sliding window: positions below
    kv_len - window are masked out (materialized path; window caches are
    small)."""
    b, hq, d = q.shape
    _, hkv, t, _ = k.shape
    group = hq // hkv
    scale = 1.0 / math.sqrt(d)
    kk = torch.repeat_interleave(k, group, dim=1)
    vv = torch.repeat_interleave(v, group, dim=1)
    logits = torch.einsum("bhd,bhtd->bht", q, kk).float() * scale
    pos = torch.arange(t, device=q.device)[None, None, :]
    lo = (kv_len - window)[:, None, None]
    hi = kv_len[:, None, None]
    mask = (pos >= torch.clamp(lo, min=0)) & (pos < hi)
    logits = logits.masked_fill(~mask, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bht,bhtd->bhd", p.to(q.dtype), vv)


def _layer_fn(cfg: ModelConfig, rules, mode: str, x: torch.Tensor,
              lp: DecoderLayer, cache_l: dict | None,
              positions: torch.Tensor, rope=None):
    x = constrain(x, rules, ("batch", "seq", "d_model"))
    x, new_cache_l = _attention_block(
        lp, x, cfg, rules, positions, mode, cache_l, rope=rope
    )
    h = apply_norm(x, lp.mlp_norm, cfg.norm)
    x = x + mlp_apply(lp.mlp, h, cfg.activation, rules)
    x = constrain(x, rules, ("batch", "seq", "d_model"))
    return x, new_cache_l


def forward(
    params: Transformer,
    tokens: torch.Tensor,  # (B, S) int — or (B, S, D) pre-embedded
    cfg: ModelConfig,
    rules=None,
    mode: str = "train",  # train | prefill | decode
    cache: kvcache.Cache | None = None,
    extra_embeds: torch.Tensor | None = None,  # VLM patch embeds (B, P, D)
) -> tuple[torch.Tensor, kvcache.Cache | None]:
    """Logits (B, S, vocab), or (B, 1, vocab) in decode mode, and the cache.
    The cache's buffers are written in place; the returned dict holds them
    with ``pos`` advanced by S (a new tensor)."""
    if tokens.ndim == 2:
        x = params.embed[tokens.long()]
    else:
        x = tokens
    if cfg.name.startswith("gemma") or cfg.name.startswith("recurrentgemma"):
        # The scale rounded to x's type first, as the reference's
        # jnp.asarray(sqrt(d), x.dtype); a Python float, so that no tensor
        # is copied to the device (a copy that waits for it).
        x = x * float(torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype))
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
    b, s, _ = x.shape

    steps = torch.arange(s, device=x.device, dtype=torch.int32)
    if mode == "decode":
        assert cache is not None
        positions = cache["pos"][:, None] + steps[None, :]
    else:
        positions = steps[None, :].expand(b, s)
    # One set of rotation tables for every layer (the reference computes
    # them in each layer; the numbers are the same).
    rope = rope_tables(positions, cfg.head_dim, cfg.rope_theta)

    layer_caches = kvcache.layer_slice(cache) if cache is not None else None
    for i, lp in enumerate(params.layers):
        cache_l = None
        if layer_caches is not None:
            cache_l = {name: buf[i] for name, buf in layer_caches.items()}
        x, _ = remat_call(cfg, mode, _layer_fn, cfg, rules, mode, x, lp,
                          cache_l, positions, rope)

    new_cache = None
    if cache is not None:
        new_cache = dict(cache)
        new_cache["pos"] = cache["pos"] + (s if mode in ("decode", "prefill")
                                           else 0)

    x = apply_norm(x, params.final_norm, cfg.norm)
    head = params.embed.T if cfg.tie_embeddings else params.lm_head
    if mode == "decode":
        x = x[:, -1:, :]
    logits = x @ head
    logits = constrain(logits, rules, ("batch", "seq", "vocab"))
    return logits, new_cache


def train_loss(
    params: Transformer,
    batch: dict,
    cfg: ModelConfig,
    rules=None,
) -> torch.Tensor:
    logits, _ = forward(
        params, batch["tokens"], cfg, rules, mode="train",
        extra_embeds=batch.get("patch_embeds"),
    )
    if batch.get("patch_embeds") is not None:
        p = batch["patch_embeds"].shape[1]
        logits = logits[:, p:, :]
    return causal_lm_loss(logits, batch["tokens"])

"""KV cache for serving: in the model's dtype or int8-quantized.

Layout: ``k``/``v`` are (L, B, KV_heads, T_max, head_dim); ``pos`` (B,)
int32 is the number of valid tokens per sequence.  The int8 path stores
per-(token, head) symmetric scales (``k_s``/``v_s``, (L, B, KV, T_max)
float32).

Unlike the reference, whose arrays are immutable, ``update_layer`` writes
the new tokens into the cache's buffers in place (one indexed store per
buffer, no host synchronisation) and returns a dict holding those same
buffers: a serving step does not copy the cache.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.device import resolve_device
from repro_torch.dist.sharding import model_split

from .config import ModelConfig

Cache = dict[str, Any]


def init_cache(
    cfg: ModelConfig,
    batch: int,
    max_len: int,
    n_layers: int | None = None,
    device: torch.device | str | None = None,
    rules=None,
) -> Cache:
    """Zeros; ``device=None`` means the GPU.  Where ``rules`` split the KV
    heads over more than one rank of ``"model"``, the cache holds this
    rank's heads (and the int8 cache's scales follow them); otherwise, as
    for gemma's single KV head, the whole cache."""
    device = resolve_device(device)
    L = n_layers if n_layers is not None else cfg.n_layers
    heads = cfg.n_kv_heads // model_split(rules, "kv_heads")
    shape = (L, batch, heads, max_len, cfg.head_dim)
    pos = torch.zeros((batch,), dtype=torch.int32, device=device)
    if cfg.kv_quant:
        return {
            "k_q": torch.zeros(shape, dtype=torch.int8, device=device),
            "v_q": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_s": torch.zeros(shape[:-1], dtype=torch.float32,
                               device=device),
            "v_s": torch.zeros(shape[:-1], dtype=torch.float32,
                               device=device),
            "pos": pos,
        }
    return {
        "k": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
        "pos": pos,
    }


def cache_logical_axes(cfg: ModelConfig) -> Cache:
    kv = ("layers", "batch", "kv_heads", "kv_seq", "head_dim")
    sc = ("layers", "batch", "kv_heads", "kv_seq")
    if cfg.kv_quant:
        return {"k_q": kv, "v_q": kv, "k_s": sc, "v_s": sc,
                "pos": ("batch",)}
    return {"k": kv, "v": kv, "pos": ("batch",)}


def _quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 per-(..., token) over head_dim.  ``torch.round``
    rounds half to even, as ``jnp.round`` does."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.clamp(amax / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    return (q.float() * scale[..., None]).to(dtype)


def layer_slice(cache: Cache) -> Cache:
    """Everything except ``pos`` (the per-layer buffers, layer axis first)."""
    return {k: v for k, v in cache.items() if k != "pos"}


def _slots(pos: torch.Tensor, b: int, s: int, t: int):
    """Index tensors (rows (B, 1), columns (B, S)) of the positions
    ``pos[b] .. pos[b] + S - 1`` of every row, the start clamped to
    [0, T - S] as ``dynamic_update_slice`` clamps it."""
    start = torch.clamp(pos.long(), 0, max(t - s, 0))
    rows = torch.arange(b, device=pos.device)[:, None]
    cols = start[:, None] + torch.arange(s, device=pos.device)
    return rows, cols


def _write(buf: torch.Tensor, val: torch.Tensor, slots) -> None:
    """``buf[b, :, pos[b]:pos[b]+S] = val[b]`` for every row ``b`` at once.
    buf (B, KV, T, ...), val (B, KV, S, ...)."""
    rows, cols = slots
    # Advanced indices on axes 0 and 2 put (B, S) first: val as (B, S, KV, ...)
    buf[rows, :, cols] = val.transpose(1, 2).to(buf.dtype)


def update_layer(
    cfg: ModelConfig,
    cache_l: Cache,  # per-layer slice: (B, KV, T, D) leaves
    k_new: torch.Tensor,  # (B, KV, S, D)
    v_new: torch.Tensor,
    pos: torch.Tensor,  # (B,) per-row write offsets (slots may diverge)
) -> Cache:
    """Writes the new tokens into ``cache_l``'s buffers in place; returns a
    dict of the same buffers."""
    out = dict(cache_l)
    b, _, s = k_new.shape[:3]
    first = cache_l["k_q" if cfg.kv_quant else "k"]
    slots = _slots(pos, b, s, first.shape[2])
    if cfg.kv_quant:
        kq, ks = _quantize(k_new)
        vq, vs = _quantize(v_new)
        _write(cache_l["k_q"], kq, slots)
        _write(cache_l["v_q"], vq, slots)
        _write(cache_l["k_s"], ks, slots)
        _write(cache_l["v_s"], vs, slots)
    else:
        _write(cache_l["k"], k_new, slots)
        _write(cache_l["v"], v_new, slots)
    return out


def read_layer(cfg: ModelConfig,
               cache_l: Cache) -> tuple[torch.Tensor, torch.Tensor]:
    if cfg.kv_quant:
        k = _dequantize(cache_l["k_q"], cache_l["k_s"], cfg.torch_dtype)
        v = _dequantize(cache_l["v_q"], cache_l["v_s"], cfg.torch_dtype)
        return k, v
    return cache_l["k"], cache_l["v"]


def advance(cache: Cache, n: int | torch.Tensor) -> Cache:
    out = dict(cache)
    out["pos"] = cache["pos"] + n
    return out

"""KV cache for serving: in the model's dtype or int8-quantized.

Layout: ``k``/``v`` are (L, B, KV_heads, T_max, head_dim); ``pos`` (B,)
int32 is the number of valid tokens per sequence.  The int8 path stores
per-(token, head) symmetric scales (``k_s``/``v_s``, (L, B, KV, T_max)
float32).

Unlike the reference, whose arrays are immutable, ``update_layer`` writes
the new tokens into the cache's buffers in place (one indexed store per
buffer, no host synchronisation) and returns a dict holding those same
buffers: a serving step does not copy the cache.

The cache's ``kv_seq`` axis may be split over the ``"model"`` ranks (the
reference's ``shard_seq``: the flash-decode distribution), where the
cache leaf's own spec gives ``"model"`` to that axis (``seq_run``): where
the rules split the KV heads too, the spec gives the axis to the heads and
the sequence stays whole.  Each rank then holds a run of ``max_len / m``
positions, writes the new tokens that fall in its run, and attends to it
alone, the ranks' partials combined by their log-sum-exp
(``models.attention.decode_attention_seq_split``).
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.device import resolve_device
from repro_torch.dist.sharding import model_split, seq_run as spec_seq_run

from .config import ModelConfig

Cache = dict[str, Any]

#: the logical axes of a cache leaf (``k``, ``v``, ``k_q``, ``v_q``) and the
#: dimension of its sequence
KV_AXES = ("layers", "batch", "kv_heads", "kv_seq", "head_dim")
SEQ_DIM = 3
#: a write that no rank splits: (ranks, offset)
WHOLE = (1, 0)


def seq_run(rules, local: int | None = None) -> tuple[int, int]:
    """(ranks, offset) of this rank's run of a cache's positions under
    ``rules``, from a cache leaf's own spec (``KV_AXES``, as
    ``models.api.state_specs`` gives it): the ranks of ``"model"`` that
    split the sequence (1 where the spec keeps it whole) and the first of
    this rank's ``local`` positions."""
    spec = None if rules is None else rules.spec(KV_AXES)
    return spec_seq_run(rules, spec, SEQ_DIM, local)


def cache_run(cache: Cache | None, rules) -> tuple[int, int]:
    """``seq_run`` of ``cache`` (whole, or a layer's slice) under
    ``rules``: a forward pass takes it once for all its layers."""
    if cache is None:
        return WHOLE
    first = cache["k_q"] if "k_q" in cache else cache["k"]
    return seq_run(rules, first.shape[-2])


def local_len(rules, max_len: int) -> int:
    """The positions a rank's cache holds of ``max_len``: all of them, or
    its run of ``max_len / m`` where ``rules`` split the sequence over
    ``m`` ranks (which must divide it, as the reference requires)."""
    m, _ = seq_run(rules)
    if max_len % m:
        raise ValueError(f"a cache of {max_len} positions does not split "
                         f"by sequence over {m} ranks")
    return max_len // m


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
    rank's heads (and the int8 cache's scales follow them); where they
    split its sequence instead (``seq_run``), this rank's run of
    ``max_len / m`` positions; otherwise, as for gemma's single KV head,
    the whole cache."""
    device = resolve_device(device)
    L = n_layers if n_layers is not None else cfg.n_layers
    heads = cfg.n_kv_heads // model_split(rules, "kv_heads")
    shape = (L, batch, heads, local_len(rules, max_len), cfg.head_dim)
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
    kv = KV_AXES
    sc = KV_AXES[:-1]
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


def _slots(pos: torch.Tensor, b: int, s: int, t: int, run=WHOLE):
    """Index tensors (rows (B, 1), columns (B, S)) of the positions
    ``pos[b] .. pos[b] + S - 1`` of every row, the start clamped to
    [0, T - S] of the whole axis as ``dynamic_update_slice`` clamps it,
    and for a rank's run (``run`` = (ranks, offset) of ``seq_run``, ``t``
    the run's length) what each column takes: None where the axis is
    whole; else, as local columns, each new token that falls in the run
    at its place, and each that falls outside on the nearest that falls
    in, with that token's value (the index into the new tokens, (B, S)),
    or, in a row none of whose tokens falls in the run, on its own place
    clamped into the run, keeping the value there (the mask, (B, S)).  No
    column is written twice with two values, and no host waits."""
    ranks, offset = run
    start = torch.clamp(pos.long(), 0, max(t * ranks - s, 0))
    rows = torch.arange(b, device=pos.device)[:, None]
    cols = start[:, None] + torch.arange(s, device=pos.device)
    if ranks == 1:
        return rows, cols, None, None
    first = start - offset  # the first new token's local column
    lo = torch.clamp(first, 0, t)
    hi = torch.clamp(first + s, 0, t)
    local = cols - offset
    keep = (hi <= lo)[:, None].expand(b, s)
    into = torch.minimum(torch.maximum(local, lo[:, None]),
                         (hi - 1)[:, None])
    local = torch.where(keep, torch.clamp(local, 0, t - 1), into)
    src = torch.clamp(local - first[:, None], 0, s - 1)
    return rows, local, src, keep


def _write(buf: torch.Tensor, val: torch.Tensor, slots) -> None:
    """``buf[b, :, pos[b]:pos[b]+S] = val[b]`` for every row ``b`` at once
    (on a rank's run, the new tokens that fall in it: ``_slots``).
    buf (B, KV, T, ...), val (B, KV, S, ...)."""
    rows, cols, src, keep = slots
    # Advanced indices on axes 0 and 2 put (B, S) first: val as (B, S, KV, ...)
    val = val.transpose(1, 2).to(buf.dtype)
    if src is not None:
        val = val[rows, src]
        old = buf[rows, :, cols]
        val = torch.where(keep.reshape(keep.shape + (1,) * (val.ndim - 2)),
                          old, val)
    buf[rows, :, cols] = val


def update_layer(
    cfg: ModelConfig,
    cache_l: Cache,  # per-layer slice: (B, KV, T, D) leaves
    k_new: torch.Tensor,  # (B, KV, S, D)
    v_new: torch.Tensor,
    pos: torch.Tensor,  # (B,) per-row write offsets (slots may diverge)
    run: tuple[int, int] = WHOLE,
) -> Cache:
    """Writes the new tokens into ``cache_l``'s buffers in place; returns a
    dict of the same buffers.  Where ``run`` (``cache_run``) splits the
    sequence, the buffers are this rank's run of it and take the tokens
    that fall there, the start clamped on the whole axis (``_slots``)."""
    out = dict(cache_l)
    b, _, s = k_new.shape[:3]
    t = cache_l["k_q" if cfg.kv_quant else "k"].shape[2]
    slots = _slots(pos, b, s, t, run)
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

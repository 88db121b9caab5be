"""Attention implementations for the model zoo.

Three interchangeable implementations selected by ``cfg.attention_impl``:

* ``cuda``  — the hand-written flash-attention kernel
  (:mod:`repro_torch.kernels.flash_attention`), the production hot path;
  on a CPU tensor its wrapper takes the plain version;
* ``xla``   — the reference's scan-over-kv-blocks online-softmax
  recurrence, as a Python loop of eager PyTorch (the name is the
  reference's);
* ``naive`` — materialized-logits oracle.

Decode-side attention (one token against the cache) has the ``cuda`` kernel
and the plain path, both able to emit the log-sum-exp for combining
sequence-split partials, on a cache in q's dtype and on the int8 cache;
``combine_decode_partials`` combines the partials of ranks that each hold
a shard of the cache's sequence axis (flash-decode over a mesh axis), and
``decode_attention_seq_split`` is a rank's whole part of it.
``decode_attention_masked`` attends to the keys a mask marks (a ring's
slots by their positions, a sliding window) with its lse.  A rank whose
shard holds no valid key of a row has zeros and lse -1e30 there, in every
path, which gets weight exactly 0.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.dist import ranks
from repro_torch.dist.collectives import _span
from repro_torch.kernels.decode_attention import decode_attention as cuda_decode
from repro_torch.kernels.decode_attention.kernel import (
    decode_attention_quant_cuda,
)
from repro_torch.kernels.decode_attention.ref import (
    EMPTY_LSE,
    decode_attention_quant_ref,
    decode_attention_ref,
)
from repro_torch.kernels.flash_attention import attention_ref, flash_attention

NEG_INF = -1e30


def xla_flash_attention(
    q: torch.Tensor,  # (B, HQ, S, D)
    k: torch.Tensor,  # (B, HKV, T, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
    q_offset: int = 0,
    block_k: int = 512,
) -> torch.Tensor:
    """Online-softmax attention over kv blocks of ``block_k`` (the
    reference's ``lax.scan`` body, run as a loop).  A ragged T is padded
    to whole blocks with zero keys, which are masked whatever ``causal``
    says; the reference masks them only through the causal or window mask,
    so its non-causal ragged result counts them in the softmax (ROADMAP
    Queue C)."""
    b, hq, s, d = q.shape
    _, hkv, t, _ = k.shape
    group = hq // hkv
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    block_k = min(block_k, t)
    t_valid = t
    if t % block_k:
        pad = block_k - t % block_k
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
        t = t + pad
    nblk = t // block_k

    qf = q.float() * scale
    q_pos = q_offset + torch.arange(s, device=q.device)
    m = torch.full((b, hq, s), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hq, s), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hq, s, d), dtype=torch.float32, device=q.device)
    for ki in range(nblk):
        sl = slice(ki * block_k, (ki + 1) * block_k)
        k_rep = torch.repeat_interleave(k[:, :, sl], group, dim=1).float()
        v_rep = torch.repeat_interleave(v[:, :, sl], group, dim=1).float()
        s_ij = torch.einsum("bhsd,bhtd->bhst", qf, k_rep)
        k_pos = ki * block_k + torch.arange(block_k, device=q.device)
        mask = (k_pos < t_valid)[None, :].expand(s, block_k)
        if causal:
            mask = mask & (q_pos[:, None] >= k_pos[None, :])
        if window is not None:
            mask = mask & ((q_pos[:, None] - k_pos[None, :]) < window)
        # masked_fill takes the fill as a number: a tensor made from one on
        # the GPU is a copy that waits for the device, in every block
        s_ij = s_ij.masked_fill(~mask[None, None], NEG_INF)
        m_cur = torch.maximum(m, s_ij.amax(dim=-1))
        alpha = torch.exp(m - m_cur)
        p = torch.exp(s_ij - m_cur[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhst,bhtd->bhsd", p,
                                                    v_rep)
        m = m_cur
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype)


def multihead_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    impl: str = "cuda",
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
    q_offset: int = 0,
) -> torch.Tensor:
    if impl == "cuda":
        return flash_attention(
            q, k, v, causal=causal, window=window, scale=scale,
            q_offset=q_offset,
        )
    if impl == "xla":
        return xla_flash_attention(
            q, k, v, causal=causal, window=window, scale=scale,
            q_offset=q_offset,
        )
    return attention_ref(
        q, k, v, causal=causal, window=window, scale=scale, q_offset=q_offset
    )


def decode_attention(
    q: torch.Tensor,  # (B, HQ, D)
    k_cache: torch.Tensor,  # (B, HKV, T, D)
    v_cache: torch.Tensor,
    kv_len: torch.Tensor,  # (B,) valid lengths
    *,
    impl: str = "cuda",
    scale: float | None = None,
    with_lse: bool = False,
) -> Any:
    if impl == "cuda":
        return cuda_decode(
            q, k_cache, v_cache, kv_len=kv_len, scale=scale, with_lse=with_lse
        )
    return decode_attention_ref(
        q, k_cache, v_cache, kv_len=kv_len, scale=scale, with_lse=with_lse
    )


def decode_attention_quant(
    q: torch.Tensor,  # (B, HQ, D)
    k_q: torch.Tensor,  # (B, HKV, T, D) int8
    k_s: torch.Tensor,  # (B, HKV, T) f32 per-token scales
    v_q: torch.Tensor,  # (B, HKV, T, D) int8
    v_s: torch.Tensor,  # (B, HKV, T) f32
    kv_len: torch.Tensor,  # (B,)
    *,
    scale: float | None = None,
    with_lse: bool = False,
    impl: str = "cuda",
) -> Any:
    """Decode attention directly on the int8 cache.  Quantization is
    per-token symmetric, so the scales factor out of both dots:

        logits[t] = k_s[t] * (q . k_q[t])
        out       = sum_t (p[t] * v_s[t]) * v_q[t]

    On a CUDA tensor with ``impl`` "cuda" this launches the hand-written
    kernel, which reads the cache once, in int8, up to ``kv_len``, by the
    route ``decode_quant_route`` gives: qwen1.5-32b's bf16 decode (a group
    of 1 at D = 128), and its rank's run of a cache split by sequence, by
    ``"gemv"`` on the CUDA cores; larger groups and D = 80 by ``"mma"``;
    f32 queries by ``"fma"``.  A CPU
    tensor, or another ``impl``, takes the plain version
    (``decode_attention_quant_ref``).  With ``with_lse`` also the
    log-sum-exp of the scaled logits (B, HQ); a row with no valid key gives
    zeros and lse -1e30, as the decode kernel does.
    """
    if impl != "cuda" or q.device.type == "cpu":
        return decode_attention_quant_ref(q, k_q, k_s, v_q, v_s, kv_len,
                                          scale=scale, with_lse=with_lse)
    out, lse = decode_attention_quant_cuda(
        q.contiguous(), k_q.contiguous(), k_s.contiguous(), v_q.contiguous(),
        v_s.contiguous(), kv_len.to(q.device, torch.int32).contiguous(),
        scale=scale)
    return (out, lse) if with_lse else out


def decode_attention_masked(
    q: torch.Tensor,  # (B, HQ, D)
    k: torch.Tensor,  # (B, HKV, T, D)
    v: torch.Tensor,
    valid: torch.Tensor,  # (B, T) bool: the keys each row attends to
    *,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Eager decode attention to the keys ``valid`` marks, with f32
    logits: (out (B, HQ, D) in q's dtype, lse (B, HQ) f32), a row with no
    valid key zeros with lse -1e30, as the decode kernel gives them.  The
    keys need not be a prefix: a ring's slots by their positions, or a
    sliding window's lower bound."""
    b, hq, d = q.shape
    group = hq // k.shape[1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    kk = torch.repeat_interleave(k, group, dim=1)
    vv = torch.repeat_interleave(v, group, dim=1)
    logits = torch.einsum("bhd,bhtd->bht", q, kk).float() * scale
    logits = logits.masked_fill(~valid[:, None, :], float("-inf"))
    m = logits.amax(dim=-1, keepdim=True)
    empty = m == float("-inf")
    m = m.masked_fill(empty, 0.0)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    out = torch.einsum("bht,bhtd->bhd", (p / l).to(q.dtype), vv)
    lse = (m + torch.log(l)).masked_fill(empty, EMPTY_LSE).squeeze(-1)
    return out, lse


def combine_decode_partials(
    out: torch.Tensor,  # (B, H, D) this rank's partial
    lse: torch.Tensor,  # (B, H) this rank's log-sum-exp
    axis_name: str,
) -> torch.Tensor:
    """Flash-decode combine across a sequence-sharded cache axis: each
    rank's partial weighted by the softmax of its lse over the ranks along
    ``axis_name`` (a pmax, then psums of the weighted f32 partials and of
    the weights: three all-reduces, in one ``collective:*`` span).  Every
    rank of the axis calls it and gets the result."""
    with _span("collective:combine_decode_partials", axis=axis_name,
               bytes=out.numel() * 4 + 2 * lse.numel() * lse.element_size()):
        m = ranks.pmax(lse, axis_name)
        w = torch.exp(lse - m)  # (B, H)
        num = ranks.psum(out.float() * w[..., None], axis_name)
        den = ranks.psum(w, axis_name)
    return (num / den[..., None]).to(out.dtype)


def decode_attention_seq_split(
    q: torch.Tensor,  # (B, HQ, D) every query head
    k_cache: torch.Tensor,  # (B, HKV, T_local, D): this rank's run
    v_cache: torch.Tensor,
    kv_len: torch.Tensor,  # (B,) valid lengths of the whole sequence
    offset: int,  # the first position of this rank's run
    axis_name: str = "model",
    *,
    mesh=None,
    impl: str = "cuda",
    scale: float | None = None,
    scales: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """A rank's part of decode attention over a cache whose sequence is
    split over ``axis_name`` (the reference's ``shard_seq``): its valid
    length within its run, ``clamp(kv_len - offset, 0, T_local)``, then the
    attention to its run with the log-sum-exp (the decode kernel, or with
    ``scales`` = (k_s, v_s) the one on the int8 cache), then
    the combine over the ranks (``mesh``: None, the current one).  Every
    rank of the axis calls it with every query head and gets the whole
    output."""
    local = torch.clamp(kv_len - offset, 0, k_cache.shape[2])
    if scales is not None:
        out, lse = decode_attention_quant(q, k_cache, scales[0], v_cache,
                                          scales[1], local, scale=scale,
                                          with_lse=True, impl=impl)
    else:
        out, lse = decode_attention(q, k_cache, v_cache, local, impl=impl,
                                    scale=scale, with_lse=True)
    with ranks.use_mesh(ranks.current_mesh() if mesh is None else mesh):
        return combine_decode_partials(out, lse, axis_name)

"""Plain PyTorch versions of single-token decode attention against a KV
cache, the oracles the kernels are held against: on a cache in q's dtype
(``decode_attention_ref``) and on an int8 cache with per-token scales
(``decode_attention_quant_ref``).

A row with no valid key (``kv_len`` 0, as a rank's shard of a
sequence-split cache can hold past a short row) gives zeros and an lse of
-1e30, as the CUDA kernel does: a combine of sequence-split partials then
gives it weight exactly 0.  (The reference's plain version gives NaN
there and its Pallas kernel the mean of v.)"""

from __future__ import annotations

import torch

#: the lse of a row with no valid key
EMPTY_LSE = -1e30


def decode_attention_ref(
    q: torch.Tensor,  # (B, HQ, D) one new token per sequence
    k: torch.Tensor,  # (B, HKV, T, D)
    v: torch.Tensor,  # (B, HKV, T, D)
    *,
    kv_len: torch.Tensor | int | None = None,  # valid cache length per row
    scale: float | None = None,
    with_lse: bool = False,
):
    b, hq, d = q.shape
    _, hkv, t, _ = k.shape
    group = hq // hkv
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    kk = torch.repeat_interleave(k, group, dim=1)
    vv = torch.repeat_interleave(v, group, dim=1)
    logits = torch.einsum("bhd,bhtd->bht", q, kk).float() * scale
    if kv_len is not None:
        kv_len = torch.as_tensor(kv_len, device=q.device)
        if kv_len.ndim == 0:
            kv_len = kv_len.expand(b)
        mask = (torch.arange(t, device=q.device)[None, None, :]
                < kv_len[:, None, None])
        logits = logits.masked_fill(~mask, float("-inf"))
    m = logits.amax(dim=-1, keepdim=True)
    empty = m == float("-inf")  # no valid key in the row
    m = m.masked_fill(empty, 0.0)
    p = torch.exp(logits - m)
    # l >= 1 wherever a key is valid (its max gives exp(0)), so the floor
    # touches only the empty rows, whose p is all 0
    l = p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    out = torch.einsum("bht,bhtd->bhd", (p / l).to(q.dtype), vv)
    if with_lse:
        lse = (m + torch.log(l)).masked_fill(empty, EMPTY_LSE).squeeze(-1)
        return out, lse  # lse (B, HQ)
    return out


def decode_attention_quant_ref(
    q: torch.Tensor,  # (B, HQ, D)
    k_q: torch.Tensor,  # (B, HKV, T, D) int8
    k_s: torch.Tensor,  # (B, HKV, T) f32 per-token scales
    v_q: torch.Tensor,  # (B, HKV, T, D) int8
    v_s: torch.Tensor,  # (B, HKV, T) f32
    kv_len: torch.Tensor,  # (B,)
    *,
    scale: float | None = None,
    with_lse: bool = False,
):
    """Decode attention on the int8 cache, eager.  Quantization is
    per-token symmetric, so the scales factor out of both dots:

        logits[t] = k_s[t] * (q . k_q[t])
        out       = sum_t (p[t] * v_s[t]) * v_q[t]

    Products of the int8 values (exact in the query's type) are summed in
    float32, as the reference's ``preferred_element_type`` does.  With
    ``with_lse`` also the log-sum-exp of the scaled logits (B, HQ); a row
    with no valid key gives zeros and lse -1e30, as the decode kernel's
    plain version does.  It widens the whole cache to q's dtype and then
    to f32 on every call; the CUDA kernel reads it once, in int8.
    """
    b, hq, d = q.shape
    _, hkv, t, _ = k_q.shape
    group = hq // hkv
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    qg = q.reshape(b, hkv, group, d)

    raw = torch.einsum("bkgd,bktd->bkgt", qg.float(),
                       k_q.to(q.dtype).float())
    logits = raw * k_s[:, :, None, :] * scale  # (B, KV, G, T)
    mask = (torch.arange(t, device=q.device)[None, None, None, :]
            < kv_len[:, None, None, None])
    logits = logits.masked_fill(~mask, float("-inf"))
    m = logits.amax(dim=-1, keepdim=True)
    empty = m == float("-inf")  # no valid key in the row
    m = m.masked_fill(empty, 0.0)
    e = torch.exp(logits - m)
    l = e.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    p = e / l
    pv = (p * v_s[:, :, None, :]).to(q.dtype)  # fold value scales in
    out = torch.einsum("bkgt,bktd->bkgd", pv.float(),
                       v_q.to(q.dtype).float())
    out = out.reshape(b, hq, d).to(q.dtype)
    if with_lse:
        lse = (m + torch.log(l)).masked_fill(empty, EMPTY_LSE)
        return out, lse.reshape(b, hq)
    return out

"""Plain PyTorch version of single-token decode attention against a KV
cache, the oracle the kernel is held against.

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

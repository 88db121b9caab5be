"""Public wrapper for flash-decode attention."""

from __future__ import annotations

import torch

from .kernel import decode_attention_cuda
from .ref import decode_attention_ref


def decode_attention(
    q: torch.Tensor,  # (B, HQ, D)
    k: torch.Tensor,  # (B, HKV, T, D)
    v: torch.Tensor,  # (B, HKV, T, D)
    *,
    kv_len: torch.Tensor | int | None = None,
    scale: float | None = None,
    block_k: int = 512,
    with_lse: bool = False,
    use_ref: bool = False,
):
    """Single-token attention against a KV cache; optionally returns the
    log-sum-exp for combining sequence-split partials (flash-decode).
    ``kv_len`` is None (the whole cache), a scalar or (B,); it goes to the
    kernel as int32 on q's device.  On a CUDA tensor this launches the
    hand-written kernel, which reads no key at or past ``kv_len``, so
    nothing is padded; a CPU tensor (or ``use_ref=True``) takes the plain
    version.  ``block_k`` is accepted for the reference's signature; the
    kernel has its own tile."""
    del block_k
    b, _, _ = q.shape
    t = k.shape[2]
    if kv_len is None:
        kv_len = torch.full((b,), t, dtype=torch.int32, device=q.device)
    else:
        kv_len = torch.as_tensor(kv_len, device=q.device).to(torch.int32)
        if kv_len.ndim == 0:
            kv_len = kv_len.expand(b)
    if use_ref or q.device.type == "cpu":
        return decode_attention_ref(q, k, v, kv_len=kv_len, scale=scale,
                                    with_lse=with_lse)
    out, lse = decode_attention_cuda(q.contiguous(), k.contiguous(),
                                     v.contiguous(), kv_len.contiguous(),
                                     scale=scale)
    if with_lse:
        return out, lse
    return out

"""Public wrapper for flash attention."""

from __future__ import annotations

import torch

from .kernel import flash_attention_cuda
from .ref import attention_ref


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
    q_offset: int = 0,
    block_q: int = 128,
    block_k: int = 128,
    use_ref: bool = False,
) -> torch.Tensor:
    """Attention of q (B, HQ, S, D) against k, v (B, HKV, T, D).  On a CUDA
    tensor this launches the hand-written kernel, which masks ragged S and T
    itself, so nothing is padded (and a non-causal ragged T, which the
    reference refuses, is masked properly); a CPU tensor (or
    ``use_ref=True``) takes the plain version.  ``block_q`` and ``block_k``
    are accepted for the reference's signature; the kernel has its own
    tiles."""
    del block_q, block_k
    if use_ref or q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             scale=scale, q_offset=q_offset)
    return flash_attention_cuda(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal=causal, window=window,
                                scale=scale, q_offset=q_offset)

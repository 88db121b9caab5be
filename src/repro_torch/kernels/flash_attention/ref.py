"""Plain PyTorch version of multi-head attention (GQA/MQA, causal,
windowed): materialized logits, the oracle the kernel is held against."""

from __future__ import annotations

import torch


def attention_ref(
    q: torch.Tensor,  # (B, HQ, S, D)
    k: torch.Tensor,  # (B, HKV, T, D)
    v: torch.Tensor,  # (B, HKV, T, D)
    *,
    causal: bool = True,
    window: int | None = None,  # local attention window (incl. self)
    scale: float | None = None,
    q_offset: int = 0,  # absolute position of q[0] (for decode)
) -> torch.Tensor:
    b, hq, s, d = q.shape
    _, hkv, t, _ = k.shape
    assert hq % hkv == 0
    group = hq // hkv
    scale = scale if scale is not None else 1.0 / (d ** 0.5)

    kk = torch.repeat_interleave(k, group, dim=1)
    vv = torch.repeat_interleave(v, group, dim=1)
    logits = torch.einsum("bhsd,bhtd->bhst", q, kk).float() * scale

    q_pos = torch.arange(s, device=q.device) + q_offset
    k_pos = torch.arange(t, device=q.device)
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        mask &= q_pos[:, None] - k_pos[None, :] < window
    logits = logits.masked_fill(~mask[None, None], float("-inf"))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhst,bhtd->bhsd", probs, vv)

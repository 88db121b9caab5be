"""Plain PyTorch version of the RG-LRU gated linear recurrence
(Griffin/RecurrentGemma, arXiv:2402.19427).

    a_t = exp(c · log(a) ⊙ r_t)           (gated per-channel decay, r_t∈(0,1))
    h_t = a_t ⊙ h_{t-1} + sqrt(1 − a_t²) ⊙ (i_t ⊙ x_t)

It takes the already-gated inputs: ``log_a_t = c · log(a) ⊙ r_t`` (≤ 0) and
the gated input ``gx_t = i_t ⊙ x_t``.  The recurrence is a first-order
linear scan per channel; the plain version runs it one step at a time in
f32, in the order of operations of the reference's Pallas kernel (and of
``csrc/rg_lru.cu``); the reference's own plain version takes
``jax.lax.associative_scan``, another order of rounding.
"""

from __future__ import annotations

import torch


def rg_lru_scan(
    log_a: torch.Tensor,  # (B, T, D) ≤ 0
    gx: torch.Tensor,  # (B, T, D) gated input
    h0: torch.Tensor | None = None,  # (B, D)
) -> torch.Tensor:
    """Every h_t (B, T, D) in f32: a = exp(log_a), beta = sqrt(max(1 - a²,
    0)), h = a h + beta gx, from ``h0`` (zeros if None)."""
    b, t, d = gx.shape
    h = (h0.float() if h0 is not None
         else torch.zeros((b, d), dtype=torch.float32, device=gx.device))
    out = torch.empty((b, t, d), dtype=torch.float32, device=gx.device)
    for i in range(t):
        a = torch.exp(log_a[:, i].float())
        beta = torch.sqrt(torch.clamp(1.0 - a * a, min=0.0))
        h = a * h + beta * gx[:, i].float()
        out[:, i] = h
    return out


def rg_lru_ref(
    log_a: torch.Tensor,  # (B, T, D) ≤ 0
    gx: torch.Tensor,  # (B, T, D) gated input
    h0: torch.Tensor | None = None,  # (B, D)
    return_state: bool = False,
):
    """Every h_t in gx's dtype and, with ``return_state``, the last one in
    gx's dtype too, as the reference's ``rg_lru_ref`` returns it (the
    public ``rg_lru`` returns the final state in f32)."""
    h = rg_lru_scan(log_a, gx, h0).to(gx.dtype)
    if return_state:
        return h, h[:, -1, :]
    return h

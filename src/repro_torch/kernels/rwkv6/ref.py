"""Plain PyTorch version of the RWKV-6 (Finch) WKV recurrence
[arXiv:2404.05892].

Per head with key dim K and value dim V, state S ∈ R^{K×V}:

    out_t = r_tᵀ (S_t + diag(u) k_t v_tᵀ)            (read with bonus)
    S_{t+1} = diag(w_t) S_t + k_t v_tᵀ               (data-dependent decay)

where w_t = exp(-exp(log_w_t)) is the per-channel decay in (0, 1).
Shapes: r/k/w (B, H, T, K), v (B, H, T, V), u (H, K) → out (B, H, T, V).

It rounds as the reference's ``wkv6_ref`` does: ``k_t v_tᵀ`` in the inputs'
type, the state in f32, and the read rounded to the inputs' type before the
dot with r.  The CUDA kernel (``csrc/wkv6.cu``) keeps ``k_t v_tᵀ``, the
state and the read in f32 and rounds only the output; in f32 the two agree.
"""

from __future__ import annotations

import torch


def wkv6_ref(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,  # decay in (0, 1): already exp(-exp(·))
    u: torch.Tensor,  # (H, K) bonus
    initial_state: torch.Tensor | None = None,  # (B, H, K, V)
    return_state: bool = False,
):
    """The reference's ``lax.scan`` as one loop over time that keeps every
    state (one fused multiply-add a step), then the reads and their dots
    with r for all steps at once: (B, H, T, K, V) floats of memory."""
    b, h, t, dk = r.shape
    dv = v.shape[-1]
    s0 = (initial_state if initial_state is not None
          else torch.zeros((b, h, dk, dv), device=r.device))
    kv = (k[..., :, None] * v[..., None, :]).float()  # (B, H, T, K, V)
    decay = w[..., :, None].float()
    states = torch.empty((b, h, t + 1, dk, dv), dtype=torch.float32,
                         device=r.device)
    states[:, :, 0] = s0.float()
    for i in range(t):  # S_{i+1} = w_i S_i + k_i v_i^T
        torch.addcmul(kv[:, :, i], decay[:, :, i], states[:, :, i],
                      out=states[:, :, i + 1])
    read = states[:, :, :t] + u[None, :, None, :, None].float() * kv
    out = torch.matmul(r[..., None, :], read.to(r.dtype))[..., 0, :]
    if return_state:
        return out, states[:, :, t].clone()
    return out

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

``rg_lru_chunked_ref`` writes out the three passes of the kernels' route
``"chunk"`` in plain PyTorch, in f32: ``rg_lru_chunk_local`` (each chunk's
scan from h = 0, and the product of its decays), ``rg_lru_chunk_carry``
(the h each chunk starts from) and ``rg_lru_chunk_outputs``.  The tests hold
it against ``rg_lru_scan`` and the reference; ``chip_smoke.py`` builds a
planted fault from its passes.  No main path calls it.
"""

from __future__ import annotations

import torch


def rg_lru_scan(
    log_a: torch.Tensor,  # (B, T, D) ≤ 0
    gx: torch.Tensor,  # (B, T, D) gated input
    h0: torch.Tensor | None = None,  # (B, D)
) -> torch.Tensor:
    """Every h_t (B, T, D) in f32: a = exp(log_a), beta = sqrt(max(1 - a²,
    0)), h = a h + beta gx, from ``h0`` (zeros if None).  Each step makes a
    new h, so that autograd differentiates the loop (the training path)."""
    b, t, d = gx.shape
    h = (h0.float() if h0 is not None
         else torch.zeros((b, d), dtype=torch.float32, device=gx.device))
    hs = []
    for i in range(t):
        a = torch.exp(log_a[:, i].float())
        beta = torch.sqrt(torch.clamp(1.0 - a * a, min=0.0))
        h = a * h + beta * gx[:, i].float()
        hs.append(h)
    return torch.stack(hs, dim=1)


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


def _chunked(x: torch.Tensor, chunk_len: int) -> torch.Tensor:
    """(B, T, D) → (B, n, L, D) in f32, T padded up to n L with zeros
    (log_a = 0 and gx = 0: a = 1 and beta = 0 leave h and the decay
    product unchanged)."""
    b, t, d = x.shape
    n = -(-t // chunk_len)
    pad = torch.zeros((b, n * chunk_len - t, d), dtype=torch.float32,
                      device=x.device)
    return torch.cat([x.float(), pad], dim=1).reshape(b, n, chunk_len, d)


def _steps(log_a, gx, h, chunk_len: int, each=None):
    """The scan's steps over every chunk at once, from h (B, n, D); the
    decay product in step order; ``each(j, h)`` after step j."""
    lac, gxc = _chunked(log_a, chunk_len), _chunked(gx, chunk_len)
    prod = torch.ones_like(h)
    for j in range(chunk_len):
        a = torch.exp(lac[:, :, j])
        beta = torch.sqrt(torch.clamp(1.0 - a * a, min=0.0))
        h = a * h + beta * gxc[:, :, j]
        prod = prod * a
        if each is not None:
            each(j, h)
    return h, prod


def rg_lru_chunk_local(log_a, gx, chunk_len: int):
    """Pass 1: for each chunk of ``chunk_len`` steps, the scan from h = 0,
    hloc (B, n, D), and the product of its decays A (B, n, D), both f32."""
    b, t, d = gx.shape
    h = torch.zeros((b, -(-t // chunk_len), d), dtype=torch.float32,
                    device=gx.device)
    return _steps(log_a, gx, h, chunk_len)


def rg_lru_chunk_carry(hloc, decays, h0):
    """Pass 2, serial over the chunks: h_in_0 = h0, h_in_{c+1} = A_c h_in_c
    + hloc_c.  Returns (the h each chunk starts from (B, n, D), the h after
    the last chunk)."""
    starts = torch.empty_like(hloc)
    h = h0.float()
    for c in range(hloc.shape[1]):
        starts[:, c] = h
        h = decays[:, c] * h + hloc[:, c]
    return starts, h


def rg_lru_chunk_outputs(log_a, gx, starts, chunk_len: int):
    """Pass 3, all chunks at once: each chunk's scan from its start; every
    h (B, T, D) in f32."""
    b, t, d = gx.shape
    out = torch.empty((b, starts.shape[1], chunk_len, d), dtype=torch.float32,
                      device=gx.device)

    def keep(j, h):
        out[:, :, j] = h

    _steps(log_a, gx, starts, chunk_len, keep)
    return out.reshape(b, -1, d)[:, :t]


def rg_lru_chunked_ref(
    log_a: torch.Tensor,  # (B, T, D) ≤ 0
    gx: torch.Tensor,  # (B, T, D) gated input
    h0: torch.Tensor | None = None,  # (B, D)
    *,
    chunk_len: int = 64,
    return_state: bool = False,
):
    """The RG-LRU scan as the chunked scan of route ``"chunk"``: the three
    passes above, in f32 (the kernel folds the carry into the outputs
    pass).  Every h in gx's dtype and, with
    ``return_state``, the final h in f32 (as the public ``rg_lru``)."""
    b, _, d = gx.shape
    h0 = (h0.float() if h0 is not None
          else torch.zeros((b, d), dtype=torch.float32, device=gx.device))
    hloc, decays = rg_lru_chunk_local(log_a, gx, chunk_len)
    starts, _ = rg_lru_chunk_carry(hloc, decays, h0)
    h = rg_lru_chunk_outputs(log_a, gx, starts, chunk_len)
    if return_state:
        return h.to(gx.dtype), h[:, -1, :]
    return h.to(gx.dtype)

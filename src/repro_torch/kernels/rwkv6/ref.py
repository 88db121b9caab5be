"""Plain PyTorch version of the RWKV-6 (Finch) WKV recurrence
[arXiv:2404.05892].

Per head with key dim K and value dim V, state S ∈ R^{K×V}:

    out_t = r_tᵀ (S_t + diag(u) k_t v_tᵀ)            (read with bonus)
    S_{t+1} = diag(w_t) S_t + k_t v_tᵀ               (data-dependent decay)

where w_t = exp(-exp(log_w_t)) is the per-channel decay in (0, 1).
Shapes: r/k/w (B, H, T, K), v (B, H, T, V), u (H, K) → out (B, H, T, V).

It rounds as the reference's ``wkv6_ref`` does: ``k_t v_tᵀ`` in the inputs'
type, the state in f32, and the read rounded to the inputs' type before the
dot with r.  The CUDA kernels (``csrc/wkv6.cu``) keep ``k_t v_tᵀ``, the
state and the read in f32 and round only the output; in f32 the two agree.

``wkv6_chunked_ref`` writes out the three passes of the kernels' route
``"chunk"`` in plain PyTorch (all in f32, the output rounded once):
``wkv6_chunk_updates`` (each chunk's update from a zero state, and its
decay product), ``wkv6_chunk_carry`` (the state each chunk starts from) and
``wkv6_chunk_outputs``.  The tests hold it against ``wkv6_ref`` and the
reference; ``chip_smoke.py`` builds a planted fault from its passes.  No
main path calls it.
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
    with r for all steps at once: (B, H, T, K, V) floats of memory.  Each
    step makes a new state, so that autograd differentiates the loop (the
    training path)."""
    b, h, t, dk = r.shape
    dv = v.shape[-1]
    s0 = (initial_state if initial_state is not None
          else torch.zeros((b, h, dk, dv), device=r.device))
    kv = (k[..., :, None] * v[..., None, :]).float()  # (B, H, T, K, V)
    decay = w[..., :, None].float()
    state = s0.float()
    states = [state]
    for i in range(t):  # S_{i+1} = w_i S_i + k_i v_i^T
        state = torch.addcmul(kv[:, :, i], decay[:, :, i], state)
        states.append(state)
    read = (torch.stack(states[:t], dim=2)
            + u[None, :, None, :, None].float() * kv)
    out = torch.matmul(r[..., None, :], read.to(r.dtype))[..., 0, :]
    if return_state:
        return out, state
    return out


def _chunked(x: torch.Tensor, chunk_len: int, fill: float) -> torch.Tensor:
    """(B, H, T, D) → (B, H, n, L, D) in f32, T padded up to n L with
    ``fill`` (w = 1 and k = 0 pass the state through unchanged)."""
    b, h, t, d = x.shape
    n = -(-t // chunk_len)
    pad = torch.full((b, h, n * chunk_len - t, d), fill, dtype=torch.float32,
                     device=x.device)
    return torch.cat([x.float(), pad], dim=2).reshape(b, h, n, chunk_len, d)


def wkv6_chunk_updates(k, v, w, chunk_len: int):
    """Pass 1: for each chunk c of ``chunk_len`` steps, the state update
    from a zero state, dS_c (B, H, n, K, V), by the serial steps
    S = w S + k vᵀ, and the decay product P_c = Π w (B, H, n, K)."""
    kc, vc = _chunked(k, chunk_len, 0.0), _chunked(v, chunk_len, 0.0)
    wc = _chunked(w, chunk_len, 1.0)
    b, h, n, _, dk = kc.shape
    ds = torch.zeros((b, h, n, dk, vc.shape[-1]), dtype=torch.float32,
                     device=k.device)
    decays = torch.ones((b, h, n, dk), dtype=torch.float32, device=k.device)
    for j in range(chunk_len):
        ds = torch.addcmul(kc[:, :, :, j, :, None] * vc[:, :, :, j, None, :],
                           wc[:, :, :, j, :, None], ds)
        decays = decays * wc[:, :, :, j]
    return ds, decays


def wkv6_chunk_carry(ds, decays, s0):
    """Pass 2, serial over the chunks: S_0 = s0, S_{c+1} = P_c S_c + dS_c.
    Returns (the state each chunk starts from (B, H, n, K, V), the final
    state)."""
    starts = torch.empty_like(ds)
    s = s0.float()
    for c in range(ds.shape[2]):
        starts[:, :, c] = s
        s = torch.addcmul(ds[:, :, c], decays[:, :, c, :, None], s)
    return starts, s


def wkv6_chunk_outputs(r, k, v, w, u, starts, chunk_len: int):
    """Pass 3, all chunks at once: each chunk's steps from its start state,
    the read with the bonus and its dot with r; the output (B, H, T, V) in
    r's dtype."""
    rc, kc = _chunked(r, chunk_len, 0.0), _chunked(k, chunk_len, 0.0)
    vc, wc = _chunked(v, chunk_len, 0.0), _chunked(w, chunk_len, 1.0)
    uu = u.float()[None, :, None, :, None]
    s = starts
    outs = []
    for j in range(chunk_len):
        kv = kc[:, :, :, j, :, None] * vc[:, :, :, j, None, :]
        read = s + uu * kv
        outs.append((rc[:, :, :, j, :, None] * read).sum(-2))
        s = torch.addcmul(kv, wc[:, :, :, j, :, None], s)
    b, h, n, _ = outs[0].shape
    out = torch.stack(outs, dim=3).reshape(b, h, n * chunk_len, -1)
    return out[:, :, :r.shape[2]].to(r.dtype)


def wkv6_chunked_ref(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    initial_state: torch.Tensor | None = None,
    *,
    chunk_len: int = 64,
    return_state: bool = False,
):
    """The WKV6 recurrence as the chunked scan of route ``"chunk"``: the
    three passes above, in f32."""
    b, h, _, dk = r.shape
    s0 = (initial_state if initial_state is not None
          else torch.zeros((b, h, dk, v.shape[-1]), device=r.device))
    ds, decays = wkv6_chunk_updates(k, v, w, chunk_len)
    starts, s_final = wkv6_chunk_carry(ds, decays, s0)
    out = wkv6_chunk_outputs(r, k, v, w, u, starts, chunk_len)
    if return_state:
        return out, s_final
    return out

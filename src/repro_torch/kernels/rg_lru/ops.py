"""Public wrapper for the RG-LRU kernels."""

from __future__ import annotations

import torch

from .kernel import rg_lru_cuda
# rg_lru_ref is re-exported: the reference's ops module offers it too
from .ref import rg_lru_ref, rg_lru_scan  # noqa: F401


def rg_lru(
    log_a: torch.Tensor,  # (B, T, D)
    gx: torch.Tensor,  # (B, T, D)
    h0: torch.Tensor | None = None,  # (B, D)
    *,
    block_t: int = 256,
    block_d: int = 512,
    return_state: bool = False,
    use_ref: bool = False,
):
    """Every h (B, T, D) in gx's dtype and, with ``return_state``, the final
    h in f32 (as the reference's kernel returns it), from ``h0`` (zeros if
    None).  On a CUDA tensor this launches the hand-written kernels (by the
    route ``rg_lru_route`` gives: the chunked scan for long T), which
    mask ragged T and D themselves, so nothing is padded; a CPU tensor (or
    ``use_ref=True``) takes the plain version.  ``block_t`` and ``block_d``
    are accepted for the reference's signature; the kernel has its own
    blocks."""
    del block_t, block_d
    if use_ref or gx.device.type == "cpu":
        h = rg_lru_scan(log_a, gx, h0)
        if return_state:
            return h.to(gx.dtype), h[:, -1, :]
        return h.to(gx.dtype)
    b, _, d = gx.shape
    h0 = (h0.float() if h0 is not None
          else torch.zeros((b, d), dtype=torch.float32, device=gx.device))
    out, h_final = rg_lru_cuda(log_a.contiguous(), gx.contiguous(),
                               h0.contiguous())
    if return_state:
        return out, h_final
    return out

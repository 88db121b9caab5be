"""Public wrapper for the WKV6 kernel."""

from __future__ import annotations

import torch

from .kernel import wkv6_cuda
from .ref import wkv6_ref


def wkv6(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    initial_state: torch.Tensor | None = None,
    *,
    block_t: int = 256,
    return_state: bool = False,
    use_ref: bool = False,
):
    """The WKV6 recurrence over r, k, w (B, H, T, K) and v (B, H, T, V) with
    bonus u (H, K) from ``initial_state`` (B, H, K, V) (zeros if None):
    out (B, H, T, V) in r's dtype and, with ``return_state``, the final
    state in f32.  On a CUDA tensor this launches the hand-written kernels,
    which mask ragged T themselves, so nothing is padded: route ``"chunk"``
    (a scan over chunks of ``kernel.CHUNK_LEN`` steps: the chunks' own
    updates, then the states carried across them, then the outputs) for T
    of two chunks or more, a prefill; route ``"fma"`` (one block walks all
    T steps) for the rest, a decode step among them (``wkv6_route``).  A CPU
    tensor (or ``use_ref=True``) takes the plain version.  ``block_t`` is
    accepted for the reference's signature; the kernels have their own
    chunks."""
    del block_t
    if use_ref or r.device.type == "cpu":
        return wkv6_ref(r, k, v, w, u, initial_state,
                        return_state=return_state)
    b, h, _, dk = r.shape
    dv = v.shape[-1]
    s0 = (initial_state.float() if initial_state is not None
          else torch.zeros((b, h, dk, dv), dtype=torch.float32,
                           device=r.device))
    out, s_final = wkv6_cuda(r.contiguous(), k.contiguous(), v.contiguous(),
                             w.contiguous(), u.float().contiguous(),
                             s0.contiguous())
    if return_state:
        return out, s_final
    return out

"""Plain PyTorch version of the Correlator benchmark (van Nieuwpoort &
Romein; paper §4.2).

Radio-astronomy correlation: for every frequency channel, correlate each
pair of antennas over time samples:

    V[c, i, j] = Σ_t  x[c, t, i] · conj(x[c, t, j])

Samples are complex, stored as a trailing (re, im) pair.  The full matrix
is kept (its two triangular halves are conjugates), as the paper's 3-D grid
(channel × antenna × antenna) computes it.
"""

from __future__ import annotations

import torch


def correlate_ref(samples: torch.Tensor) -> torch.Tensor:
    """samples: (channels, time, antennas, 2) → (channels, ant, ant, 2)."""
    re = samples[..., 0]  # (c, t, a)
    im = samples[..., 1]
    # V_ij = Σ_t x_i conj(x_j):
    #   re: re_i re_j + im_i im_j,  im: im_i re_j − re_i im_j
    vr = torch.einsum("cti,ctj->cij", re, re) + torch.einsum(
        "cti,ctj->cij", im, im)
    vi = torch.einsum("cti,ctj->cij", im, re) - torch.einsum(
        "cti,ctj->cij", re, im)
    return torch.stack([vr, vi], dim=-1)

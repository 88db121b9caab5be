"""Public wrapper for the correlator kernel."""

from __future__ import annotations

import torch

from .kernel import correlate_cuda
from .ref import correlate_ref


def correlate(
    samples: torch.Tensor,
    *,
    block_t: int = 512,
    use_ref: bool = False,
) -> torch.Tensor:
    """Visibilities (C, A, A, 2) of samples (C, T, A, 2), in the samples'
    type (f32 or bf16; the kernels sum in f32).  On a CUDA tensor this
    launches a hand-written kernel, which reads samples past T as 0 itself,
    so nothing is padded: route ``"tri"`` (only the 64 x 64 tiles of
    antenna pairs with i <= j, each off-diagonal one also written as its
    conjugate transpose) for more than 64 antennas, route ``"fma"`` (every
    tile) for the rest (``correlate_route``).  A CPU tensor (or
    ``use_ref=True``) takes the plain version.  ``block_t`` is accepted for
    the reference's signature; the kernels have their own tile."""
    del block_t
    if use_ref or samples.device.type == "cpu":
        return correlate_ref(samples)
    return correlate_cuda(samples.contiguous())

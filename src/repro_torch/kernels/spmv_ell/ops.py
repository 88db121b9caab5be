"""Public wrapper for the ELL SpMV kernel."""

from __future__ import annotations

import torch

from .kernel import spmv_ell_cuda
from .ref import spmv_ell_ref


def spmv_ell(
    data: torch.Tensor,
    cols: torch.Tensor,
    x: torch.Tensor,
    *,
    block: int = 2048,
    use_ref: bool = False,
) -> torch.Tensor:
    """y = A @ x for A in ELL format (padded entries must have data == 0).

    On a CUDA tensor this launches the hand-written kernel, which masks the
    last rows itself, so nothing is padded; a CPU tensor (or
    ``use_ref=True``) takes the plain version.  ``block`` is accepted for
    the reference's signature; the kernel picks its own grid."""
    del block
    if use_ref or data.device.type == "cpu":
        return spmv_ell_ref(data, cols, x)
    return spmv_ell_cuda(data, cols, x)

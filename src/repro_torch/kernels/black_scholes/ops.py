"""Public wrapper for the Black-Scholes kernel."""

from __future__ import annotations

import torch

from .kernel import black_scholes_cuda
from .ref import black_scholes_ref


def black_scholes(
    price: torch.Tensor,
    strike: torch.Tensor,
    years: torch.Tensor,
    *,
    block: int = 8 * 128 * 64,
    riskfree: float = 0.02,
    volatility: float = 0.30,
    use_ref: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(call, put) prices.  On a CUDA tensor this launches the hand-written
    kernel, which masks the ragged end itself, so nothing is padded; a CPU
    tensor (or ``use_ref=True``) takes the plain version.  ``block`` is
    accepted for the reference's signature; the kernel picks its own
    grid."""
    del block
    if use_ref or price.device.type == "cpu":
        return black_scholes_ref(price, strike, years, riskfree=riskfree,
                                 volatility=volatility)
    return black_scholes_cuda(price, strike, years, riskfree=riskfree,
                              volatility=volatility)

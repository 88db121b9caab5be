"""Plain PyTorch version of the Black-Scholes benchmark (CUDA samples; paper
§4.2).

Computes European call/put option prices.  Embarrassingly parallel and
memory-bound: the paper's canonical "spilling never pays" workload.
"""

from __future__ import annotations

import math

import torch


def _cnd(x: torch.Tensor) -> torch.Tensor:
    """Cumulative normal distribution via erf."""
    return 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))


def black_scholes_ref(
    price: torch.Tensor,
    strike: torch.Tensor,
    years: torch.Tensor,
    *,
    riskfree: float = 0.02,
    volatility: float = 0.30,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (call, put) prices."""
    sqrt_t = torch.sqrt(years)
    d1 = (torch.log(price / strike)
          + (riskfree + 0.5 * volatility * volatility) * years) / (
        volatility * sqrt_t
    )
    d2 = d1 - volatility * sqrt_t
    cnd_d1 = _cnd(d1)
    cnd_d2 = _cnd(d2)
    exp_rt = torch.exp(-riskfree * years)
    call = price * cnd_d1 - strike * exp_rt * cnd_d2
    put = strike * exp_rt * (1.0 - cnd_d2) - price * (1.0 - cnd_d1)
    return call, put

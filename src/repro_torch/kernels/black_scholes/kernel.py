"""Launches the Black-Scholes CUDA kernel (``csrc/black_scholes.cu``)."""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..common import cdiv, check_cuda_tensor, stride_grid


def black_scholes_cuda(
    price: torch.Tensor,  # (n,) f32, CUDA
    strike: torch.Tensor,  # (n,) f32, CUDA
    years: torch.Tensor,  # (n,) f32, CUDA
    *,
    riskfree: float = 0.02,
    volatility: float = 0.30,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(call, put), each (n,) f32, into new tensors."""
    check_cuda_tensor("price", price, (torch.float32,), 1)
    check_cuda_tensor("strike", strike, (torch.float32,), 1,
                      device=price.device)
    check_cuda_tensor("years", years, (torch.float32,), 1, device=price.device)
    if not price.shape == strike.shape == years.shape:
        raise ValueError(f"shapes disagree: price {tuple(price.shape)}, "
                         f"strike {tuple(strike.shape)}, "
                         f"years {tuple(years.shape)}")
    n = price.shape[0]
    call, put = torch.empty_like(price), torch.empty_like(price)
    if n == 0:
        return call, put
    # 16-byte loads and stores only where all five buffers allow them.
    vec = all(t.data_ptr() % 16 == 0 for t in (price, strike, years, call, put))
    grid = stride_grid(cdiv(n, 4), price.device)
    fn = _build.bind("black_scholes_f32", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ])
    # The scalars as the reference forms them: Python floats (double) made
    # f32 where they meet an f32 array.
    with torch.cuda.device(price.device):
        err = fn(price.data_ptr(), strike.data_ptr(), years.data_ptr(),
                 call.data_ptr(), put.data_ptr(), n,
                 riskfree + 0.5 * volatility * volatility, volatility,
                 -riskfree, int(vec), grid,
                 torch.cuda.current_stream().cuda_stream)
    black_scholes_cuda.launches += 1
    _build.check(err, "black_scholes_f32")
    return call, put


#: launches of the CUDA kernel in this process
black_scholes_cuda.launches = 0

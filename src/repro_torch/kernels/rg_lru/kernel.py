"""Launches the RG-LRU CUDA kernel (``csrc/rg_lru.cu``)."""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..common import check_cuda_tensor

_TYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def rg_lru_cuda(
    log_a: torch.Tensor,  # (B, T, D) f32 or bf16, CUDA, contiguous
    gx: torch.Tensor,  # (B, T, D) same dtype
    h0: torch.Tensor,  # (B, D) f32
) -> tuple[torch.Tensor, torch.Tensor]:
    """(every h (B, T, D) in gx's dtype, final h (B, D) f32) in new
    tensors.  Ragged T and D are masked inside the kernel."""
    check_cuda_tensor("gx", gx, tuple(_TYPE_CODES), 3)
    check_cuda_tensor("log_a", log_a, (gx.dtype,), 3, device=gx.device)
    check_cuda_tensor("h0", h0, (torch.float32,), 2, device=gx.device)
    b, t, d = gx.shape
    if log_a.shape != gx.shape or h0.shape != (b, d):
        raise ValueError(f"shapes disagree: log_a {tuple(log_a.shape)}, "
                         f"gx {tuple(gx.shape)}, h0 {tuple(h0.shape)}")
    if b > 65535 or b * t * d >= 2**62 or t >= 2**31 or d >= 2**31:
        raise ValueError(f"too large: B={b}, T={t}, D={d}")
    out = torch.empty_like(gx)
    if b * d == 0:
        return out, h0.clone()
    h_final = torch.empty_like(h0)
    fn = _build.bind("rg_lru_fwd", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ])
    with torch.cuda.device(gx.device):
        err = fn(log_a.data_ptr(), gx.data_ptr(), h0.data_ptr(),
                 out.data_ptr(), h_final.data_ptr(), b, t, d,
                 _TYPE_CODES[gx.dtype],
                 torch.cuda.current_stream().cuda_stream)
    rg_lru_cuda.launches += 1
    _build.check(err, "rg_lru_fwd")
    return out, h_final


#: launches of the CUDA kernel in this process
rg_lru_cuda.launches = 0

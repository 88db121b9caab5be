"""Launches the GEMM CUDA kernel (``csrc/gemm.cu``)."""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..common import check_cuda_tensor

_TYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def gemm_cuda(
    a: torch.Tensor,  # (m, k) f32 or bf16, CUDA
    b: torch.Tensor,  # (k, n) same dtype, CUDA
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """``a @ b`` accumulated in f32, as ``out_dtype`` (default: a's)."""
    check_cuda_tensor("a", a, tuple(_TYPE_CODES), 2)
    check_cuda_tensor("b", b, (a.dtype,), 2, device=a.device)
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"shapes disagree: a {tuple(a.shape)}, "
                         f"b {tuple(b.shape)}")
    out_dtype = out_dtype or a.dtype
    if out_dtype not in _TYPE_CODES:
        raise TypeError(f"out_dtype {out_dtype} not in {tuple(_TYPE_CODES)}")
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if m == 0 or n == 0:
        return out
    fn = _build.bind("gemm_rowmajor", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ])
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
                 _TYPE_CODES[a.dtype], _TYPE_CODES[out_dtype],
                 torch.cuda.current_stream().cuda_stream)
    gemm_cuda.launches += 1
    _build.check(err, "gemm_rowmajor")
    return out


#: launches of the CUDA kernel in this process
gemm_cuda.launches = 0

"""Launches the ELL SpMV CUDA kernel (``csrc/spmv_ell.cu``)."""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..common import cdiv, check_cuda_tensor


def lanes_per_row(nnz: int, vec: bool) -> int:
    """Lanes of the group that takes one row: enough for one 16-byte load
    (or one entry) each, a power of two, at most a warp."""
    per_row = cdiv(nnz, 4) if vec else nnz
    lanes = 1
    while lanes < min(per_row, 32):
        lanes *= 2
    return lanes


def spmv_ell_cuda(
    data: torch.Tensor,  # (rows, max_nnz) f32, CUDA
    cols: torch.Tensor,  # (rows, max_nnz) int32, CUDA
    x: torch.Tensor,  # (n,) f32, CUDA
) -> torch.Tensor:
    """y (rows,) f32 into a new tensor."""
    check_cuda_tensor("data", data, (torch.float32,), 2)
    check_cuda_tensor("cols", cols, (torch.int32,), 2, device=data.device)
    check_cuda_tensor("x", x, (torch.float32,), 1, device=data.device)
    if data.shape != cols.shape:
        raise ValueError(f"shapes disagree: data {tuple(data.shape)}, "
                         f"cols {tuple(cols.shape)}")
    rows, nnz = data.shape
    n = x.shape[0]
    if n >= 2**31:
        raise ValueError(f"x has {n} entries; int32 columns reach 2**31 - 1")
    y = torch.empty((rows,), dtype=torch.float32, device=data.device)
    if rows == 0:
        return y
    vec = (nnz % 4 == 0 and data.data_ptr() % 16 == 0
           and cols.data_ptr() % 16 == 0)
    fn = _build.bind("spmv_ell_f32", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ])
    with torch.cuda.device(data.device):
        err = fn(data.data_ptr(), cols.data_ptr(), x.data_ptr(), y.data_ptr(),
                 rows, nnz, n, lanes_per_row(nnz, vec), int(vec),
                 torch.cuda.current_stream().cuda_stream)
    spmv_ell_cuda.launches += 1
    _build.check(err, "spmv_ell_f32")
    return y


#: launches of the CUDA kernel in this process
spmv_ell_cuda.launches = 0

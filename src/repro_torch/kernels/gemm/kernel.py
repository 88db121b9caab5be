"""Launches the GEMM CUDA kernels (``csrc/gemm.cu``) by one of two routes."""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..common import ROUTES, check_cuda_tensor, resolve_route

_TYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def gemm_route(a: torch.Tensor, b: torch.Tensor) -> str:
    """The kernel a product takes, from dtype, shape and alignment alone.

    ``"wgmma"`` (tensor cores fed by TMA) for bf16 inputs that TMA can
    describe: a row stride of whole 16-byte units (K and N multiples of 8)
    and 16-byte-aligned bases, with K at least 1.  ``"fma"`` (f32 on the
    CUDA cores) for everything else: all f32 inputs, and bf16 shapes such
    as K = 60, whose 120-byte rows TMA refuses."""
    k, n = b.shape
    if (a.dtype == b.dtype == torch.bfloat16 and k > 0 and k % 8 == 0
            and n % 8 == 0 and a.data_ptr() % 16 == 0
            and b.data_ptr() % 16 == 0):
        return "wgmma"
    return "fma"


def gemm_cuda(
    a: torch.Tensor,  # (m, k) f32 or bf16, CUDA
    b: torch.Tensor,  # (k, n) same dtype, CUDA
    out_dtype: torch.dtype | None = None,
    *,
    route: str | None = None,
) -> torch.Tensor:
    """``a @ b`` accumulated in f32, as ``out_dtype`` (default: a's).

    ``route`` None takes ``gemm_route``'s choice; ``"fma"`` forces the CUDA
    cores' kernel on inputs the tensor cores could take (to time the two on
    the same inputs).  A failed launch raises; no route is tried after
    another fails."""
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
    route = resolve_route(route, gemm_route(a, b), "gemm")
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if m == 0 or n == 0:
        return out
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with torch.cuda.device(a.device):
        if route == "wgmma":
            fn = _build.bind("gemm_bf16_wgmma", [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p,
            ])
            err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
                     _TYPE_CODES[out_dtype], stream)
        else:
            fn = _build.bind("gemm_rowmajor", [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p,
            ])
            err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
                     _TYPE_CODES[a.dtype], _TYPE_CODES[out_dtype], stream)
    gemm_cuda.launches += 1
    gemm_cuda.routes[route] += 1
    _build.check(err, f"gemm ({route})")
    return out


#: launches of the CUDA kernels in this process, and by route
gemm_cuda.launches = 0
gemm_cuda.routes = dict.fromkeys(ROUTES, 0)

"""Launches the GEMM CUDA kernels (``csrc/gemm.cu``) by one of three routes."""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..common import check_cuda_tensor, resolve_route

_TYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the routes: bf16 on the tensor cores fed by TMA, f32 on the CUDA cores
#: with its loads one stage ahead, and the first kernel (CUDA cores)
ROUTES = ("wgmma", "pipe", "fma")
#: the C entries of the routes after the first kernel's (one signature)
_ENTRIES = {"wgmma": "gemm_bf16_wgmma", "pipe": "gemm_f32_pipe"}


def gemm_route(a: torch.Tensor, b: torch.Tensor,
               out_dtype: torch.dtype | None = None) -> str:
    """The kernel a product takes, from dtype, shape and alignment alone.

    ``"wgmma"`` (tensor cores fed by TMA) for bf16 inputs that TMA can
    describe: a row stride of whole 16-byte units (K and N multiples of 8)
    and 16-byte-aligned bases, with K at least 1.  ``"pipe"`` (true f32 on
    the CUDA cores, its loads one stage ahead) for f32 inputs with K a
    positive multiple of 16 (whole stages) and N of 4 (rows of whole
    16-byte units), 16-byte-aligned bases and an f32 result (``out_dtype``
    None: the inputs').  ``"fma"`` (the first kernel) for everything else,
    such as chip_smoke's ragged K = 60 in bf16, or K = 136, N = 130 or a
    bf16 result in f32."""
    k, n = b.shape
    aligned = a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0
    if not aligned or k == 0 or a.dtype != b.dtype:
        return "fma"
    if a.dtype == torch.bfloat16 and k % 8 == 0 and n % 8 == 0:
        return "wgmma"
    if (a.dtype == torch.float32 and k % 16 == 0 and n % 4 == 0
            and out_dtype in (None, torch.float32)):
        return "pipe"
    return "fma"


def gemm_cuda(
    a: torch.Tensor,  # (m, k) f32 or bf16, CUDA
    b: torch.Tensor,  # (k, n) same dtype, CUDA
    out_dtype: torch.dtype | None = None,
    *,
    route: str | None = None,
) -> torch.Tensor:
    """``a @ b`` accumulated in f32, as ``out_dtype`` (default: a's).

    ``route`` None takes ``gemm_route``'s choice; ``"fma"`` forces the first
    kernel on inputs another route could take (to time the two on the same
    inputs).  A failed launch raises; no route is tried after
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
    route = resolve_route(route, gemm_route(a, b, out_dtype), ROUTES, "gemm")
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if m == 0 or n == 0:
        return out
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with torch.cuda.device(a.device):
        if route in _ENTRIES:
            fn = _build.bind(_ENTRIES[route], [
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

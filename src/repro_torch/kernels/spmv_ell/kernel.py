"""Launches the ELL SpMV CUDA kernels (``csrc/spmv_ell.cu``) by one of two
routes: ``"bin"``, which bins the entries into tiles whose slice of x sits
in L2 before it gathers, and ``"fma"``, the first kernel, a group of lanes
a row gathering straight from x.  Both first run a pass over x that sets a
flag on the device where x holds a NaN or an inf; where x is finite, an
entry with data == 0 is not gathered (its term is +-0)."""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..common import cdiv, check_cuda_tensor, resolve_route, stride_grid
from .ref import BLOCK_ENTRIES, MAX_SLICES, SLICE_BITS, bin_layout

#: the routes: the entries binned into tiles first, and the first kernel
ROUTES = ("bin", "fma")
#: route ``"bin"`` takes an x of at least this many columns (64 MiB, past
#: the 50 MB of L2; at 2^23 route ``"fma"`` was faster on an H100, at 2^24
#: ``"bin"``: ``tools/cuda_core_probe.py``'s sweep over n) and at least
#: this many rows (at n = 2^25, route ``"fma"`` was faster at 2^19 rows
#: and below, ``"bin"`` from 2^20: the probe's sweep over rows)
BIN_MIN_N = 1 << 24
BIN_MIN_ROWS = 1 << 20


def lanes_per_row(nnz: int, vec: bool) -> int:
    """Lanes of route ``"fma"``'s group that takes one row: enough for one
    16-byte load (or one entry) each, a power of two, at most a warp."""
    per_row = cdiv(nnz, 4) if vec else nnz
    lanes = 1
    while lanes < min(per_row, 32):
        lanes *= 2
    return lanes


def spmv_route(data: torch.Tensor, cols: torch.Tensor, x: torch.Tensor) -> str:
    """The route a call takes, from shapes and alignment alone: ``"bin"``
    for an x past ``BIN_MIN_N`` columns, at least ``BIN_MIN_ROWS`` rows,
    max_nnz a multiple of 4 (16-byte loads) and at most ``BLOCK_ENTRIES``,
    16-byte aligned data and cols, fewer than 2^31 entries and at most
    ``MAX_SLICES`` slices; else ``"fma"`` (the first kernel)."""
    rows, nnz = data.shape
    n = x.shape[0]
    fits = (nnz % 4 == 0 and 0 < nnz <= BLOCK_ENTRIES
            and 0 < rows * nnz < 2**31
            and cdiv(n, 1 << SLICE_BITS) <= MAX_SLICES
            and data.data_ptr() % 16 == 0 and cols.data_ptr() % 16 == 0)
    return "bin" if fits and n >= BIN_MIN_N and rows >= BIN_MIN_ROWS else "fma"


def spmv_ell_cuda(
    data: torch.Tensor,  # (rows, max_nnz) f32, CUDA
    cols: torch.Tensor,  # (rows, max_nnz) int32, CUDA
    x: torch.Tensor,  # (n,) f32, CUDA
    *,
    route: str | None = None,
) -> torch.Tensor:
    """y (rows,) f32 into a new tensor.

    ``route`` None takes ``spmv_route``'s choice; ``"fma"`` forces the
    first kernel on inputs route ``"bin"`` could take (to time the two on
    the same inputs).  Route ``"bin"`` holds rows * max_nnz entries of 8
    bytes on the device while it runs."""
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
    route = resolve_route(route, spmv_route(data, cols, x), ROUTES, "spmv_ell")
    if rows == 0:
        return torch.empty((0,), dtype=torch.float32, device=data.device)
    nonfinite = torch.zeros((1,), dtype=torch.int32, device=data.device)
    grid = stride_grid(cdiv(n, 4), data.device)
    stream = torch.cuda.current_stream(data.device).cuda_stream
    if route == "bin":
        lay = bin_layout(rows, nnz, n, SLICE_BITS)
        y = torch.empty((rows,), dtype=torch.float32, device=data.device)
        starts = torch.empty((lay["count_blocks"], lay["slices"] + 1),
                             dtype=torch.int32, device=data.device)
        bins = torch.empty(
            (lay["count_blocks"] << lay["block_row_bits"], nnz),
            dtype=torch.int64, device=data.device)
        fn = _build.bind("spmv_ell_bin_f32", [ctypes.c_void_p] * 4 + [
            ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
            + [ctypes.c_int, ctypes.c_void_p])
        with torch.cuda.device(data.device):
            err = fn(data.data_ptr(), cols.data_ptr(), x.data_ptr(),
                     y.data_ptr(), rows, nnz, n, SLICE_BITS,
                     lay["block_row_bits"], nonfinite.data_ptr(),
                     starts.data_ptr(), bins.data_ptr(), grid, stream)
    else:
        y = torch.empty((rows,), dtype=torch.float32, device=data.device)
        vec = (nnz % 4 == 0 and data.data_ptr() % 16 == 0
               and cols.data_ptr() % 16 == 0)
        fn = _build.bind("spmv_ell_f32", [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ])
        with torch.cuda.device(data.device):
            err = fn(data.data_ptr(), cols.data_ptr(), x.data_ptr(),
                     y.data_ptr(), rows, nnz, n, lanes_per_row(nnz, vec),
                     int(vec), nonfinite.data_ptr(), grid, stream)
    spmv_ell_cuda.launches += 1
    spmv_ell_cuda.routes[route] += 1
    _build.check(err, f"spmv_ell ({route})")
    return y


#: launches of the CUDA kernels in this process, and by route
spmv_ell_cuda.launches = 0
spmv_ell_cuda.routes = dict.fromkeys(ROUTES, 0)

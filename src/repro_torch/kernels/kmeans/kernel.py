"""Launches the K-Means CUDA kernel (``csrc/kmeans.cu``).

The kernel writes one partial per block: sums ``(grid, k, f)`` f32 and
counts ``(grid, k)`` int32.  The caller reduces over the leading axis.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..common import H100_MAX_SHARED_BYTES, cdiv, check_cuda_tensor, sm_count

#: blocks per SM of the fixed grid that walks the points
BLOCKS_PER_SM = 4


def kmeans_cuda(
    points: torch.Tensor,  # (n, f) f32, CUDA
    centroids: torch.Tensor,  # (k, f) f32, CUDA
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-block partials ``(sums (grid,k,f) f32, counts (grid,k) int32)``."""
    check_cuda_tensor("points", points, (torch.float32,), 2)
    check_cuda_tensor("centroids", centroids, (torch.float32,), 2,
                      device=points.device)
    n, f = points.shape
    k, f2 = centroids.shape
    if f != f2 or k < 1 or f < 1:
        raise ValueError(f"shapes disagree: points {tuple(points.shape)}, "
                         f"centroids {tuple(centroids.shape)}")
    if f == 4 and points.data_ptr() % 16:
        raise ValueError("points with 4 features must be 16-byte aligned")
    shared = (2 * k * f + 2 * k) * 4
    if shared > H100_MAX_SHARED_BYTES:
        raise ValueError(
            f"k*f = {k * f} needs {shared} bytes of shared memory, more "
            f"than the {H100_MAX_SHARED_BYTES} a block can have")

    threads = _build.bind("kmeans_threads_per_block", [])()
    grid = max(1, min(cdiv(n, threads),
                      BLOCKS_PER_SM * sm_count(points.device.index)))
    part_sums = torch.empty((grid, k, f), dtype=torch.float32,
                            device=points.device)
    part_counts = torch.empty((grid, k), dtype=torch.int32,
                              device=points.device)
    fn = _build.bind("kmeans_assign_partials_f32", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ])
    with torch.cuda.device(points.device):
        err = fn(points.data_ptr(), centroids.data_ptr(),
                 part_sums.data_ptr(), part_counts.data_ptr(), n, f, k, grid,
                 torch.cuda.current_stream().cuda_stream)
    kmeans_cuda.launches += 1
    _build.check(err, "kmeans_assign_partials_f32")
    return part_sums, part_counts


#: launches of the CUDA kernel in this process
kmeans_cuda.launches = 0

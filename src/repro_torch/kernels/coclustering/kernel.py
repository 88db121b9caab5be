"""Launches the co-cluster sums CUDA kernel (``csrc/cluster_sums.cu``).

The kernel writes one ``(R, C)`` partial per block of (256 columns × a slab
of rows).  The caller reduces over the leading axis.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..common import H100_MAX_SHARED_BYTES, cdiv, check_cuda_tensor, sm_count

#: blocks per SM aimed at when the rows are cut into slabs
BLOCKS_PER_SM = 8


def cluster_sums_cuda(
    z: torch.Tensor,  # (n, m) f32, CUDA
    row_assign: torch.Tensor,  # (n,) int32, CUDA
    col_assign: torch.Tensor,  # (m,) int32, CUDA
    nrow_clusters: int,
    ncol_clusters: int,
) -> torch.Tensor:
    """Per-block partials ``(blocks, R, C)`` f32."""
    check_cuda_tensor("z", z, (torch.float32,), 2)
    check_cuda_tensor("row_assign", row_assign, (torch.int32,), 1,
                      device=z.device)
    check_cuda_tensor("col_assign", col_assign, (torch.int32,), 1,
                      device=z.device)
    n, m = z.shape
    if row_assign.shape[0] != n or col_assign.shape[0] != m:
        raise ValueError(
            f"shapes disagree: z {tuple(z.shape)}, row_assign "
            f"{tuple(row_assign.shape)}, col_assign {tuple(col_assign.shape)}")
    if nrow_clusters < 1 or ncol_clusters < 1:
        raise ValueError("cluster counts must be positive")
    if n == 0 or m == 0:
        return torch.zeros((1, nrow_clusters, ncol_clusters),
                           dtype=torch.float32, device=z.device)

    threads = _build.bind("cluster_sums_threads_per_block", [])()
    shared = (nrow_clusters * threads + nrow_clusters * ncol_clusters) * 4
    if shared > H100_MAX_SHARED_BYTES:
        raise ValueError(
            f"{nrow_clusters} row clusters need {shared} bytes of shared "
            f"memory, more than the {H100_MAX_SHARED_BYTES} a block can have")
    col_chunks = cdiv(m, threads)
    target = BLOCKS_PER_SM * sm_count(z.device.index)
    row_slabs = max(1, min(n, cdiv(target, col_chunks), 65535))
    rows_per_slab = cdiv(n, row_slabs)
    row_slabs = cdiv(n, rows_per_slab)
    partials = torch.empty(
        (col_chunks * row_slabs, nrow_clusters, ncol_clusters),
        dtype=torch.float32, device=z.device)
    fn = _build.bind("cluster_sums_partials_f32", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ])
    with torch.cuda.device(z.device):
        err = fn(z.data_ptr(), row_assign.data_ptr(), col_assign.data_ptr(),
                 partials.data_ptr(), n, m, nrow_clusters, ncol_clusters,
                 row_slabs, rows_per_slab,
                 torch.cuda.current_stream().cuda_stream)
    cluster_sums_cuda.launches += 1
    _build.check(err, "cluster_sums_partials_f32")
    return partials


#: launches of the CUDA kernel in this process
cluster_sums_cuda.launches = 0

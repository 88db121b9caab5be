"""Public wrapper for the co-clustering cluster-sum kernel."""

from __future__ import annotations

import torch

from .kernel import cluster_sums_cuda
from .ref import cluster_sums_ref


def cluster_sums(
    z: torch.Tensor,
    row_assign: torch.Tensor,
    col_assign: torch.Tensor,
    nrow_clusters: int,
    ncol_clusters: int,
    *,
    block_n: int = 1024,
    use_ref: bool = False,
) -> torch.Tensor:
    """Co-cluster sums ``(R, C)``.  On a CUDA tensor this launches the
    hand-written kernel, which takes the assignments as int32 and masks the
    ragged edges itself; a CPU tensor (or ``use_ref=True``) takes the plain
    version.  ``block_n`` is accepted for the reference's signature; the
    kernel cuts the rows into slabs itself."""
    del block_n
    if use_ref or z.device.type == "cpu":
        return cluster_sums_ref(
            z, row_assign, col_assign, nrow_clusters, ncol_clusters
        )
    partials = cluster_sums_cuda(
        z, row_assign.to(torch.int32), col_assign.to(torch.int32),
        nrow_clusters, ncol_clusters,
    )
    return partials.sum(dim=0)

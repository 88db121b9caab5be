"""Plain PyTorch version of the K-Means benchmark (Rodinia; paper §4.2).

Each iteration: assign every record to its nearest centroid, then recompute
centroids as per-cluster means.  The paper highlights that Lightning moves
the centre recalculation onto the GPU via ``reduce(+)`` annotations.
"""

from __future__ import annotations

import torch


def nearest_centroid(points: torch.Tensor,
                     centroids: torch.Tensor) -> torch.Tensor:
    """Index of the nearest centroid per point, (n,) int64: distances by
    ``|p|² − 2p·cᵀ + |c|²``, the lowest index on a tie.  (``torch.argmin``
    does not promise which of several minima it returns, so the tie rule
    is written out.)"""
    d2 = (
        torch.sum(points * points, dim=1, keepdim=True)
        - 2.0 * (points @ centroids.T)
        + torch.sum(centroids * centroids, dim=1)[None, :]
    )  # (n, k)
    k = centroids.shape[0]
    index = torch.arange(k, dtype=torch.int32, device=points.device)
    is_min = d2 == d2.amin(dim=1, keepdim=True)
    return torch.where(is_min, index, k).amin(dim=1).long()


def kmeans_assign_reduce_ref(
    points: torch.Tensor,  # (n, f)
    centroids: torch.Tensor,  # (k, f)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (sums (k, f), counts (k,)) of points per nearest centroid."""
    k = centroids.shape[0]
    assign = nearest_centroid(points, centroids)
    onehot = (assign[:, None] == torch.arange(k, device=points.device)
              ).to(points.dtype)
    sums = onehot.T @ points
    counts = onehot.sum(dim=0)
    return sums, counts


def kmeans_iteration_ref(
    points: torch.Tensor, centroids: torch.Tensor
) -> torch.Tensor:
    sums, counts = kmeans_assign_reduce_ref(points, centroids)
    counts = torch.clamp(counts, min=1.0)
    return sums / counts[:, None]

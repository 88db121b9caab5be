"""Public wrappers for the K-Means kernel."""

from __future__ import annotations

import torch

from .kernel import kmeans_cuda
from .ref import kmeans_assign_reduce_ref, kmeans_iteration_ref


def kmeans_assign_reduce(
    points: torch.Tensor,
    centroids: torch.Tensor,
    *,
    block: int = 4096,
    use_ref: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(sums (k,f), counts (k,)) — block partials reduced on-device.

    On a CUDA tensor this launches the hand-written kernel; a CPU tensor
    (or ``use_ref=True``) takes the plain version.  The kernel masks rows
    itself, so nothing is padded and no pad count is corrected.  ``block``
    is accepted for the reference's signature; the kernel picks its own
    grid.  Counts are returned as f32 and are exact below 2**24 per
    cluster."""
    del block
    if use_ref or points.device.type == "cpu":
        return kmeans_assign_reduce_ref(points, centroids)
    part_sums, part_counts = kmeans_cuda(points, centroids)
    return part_sums.sum(dim=0), part_counts.sum(dim=0).to(torch.float32)


def kmeans_iteration(
    points: torch.Tensor,
    centroids: torch.Tensor,
    **kw,
) -> torch.Tensor:
    """One full K-Means iteration (assignment + centroid update)."""
    if kw.pop("use_ref", False):
        return kmeans_iteration_ref(points, centroids)
    sums, counts = kmeans_assign_reduce(points, centroids, **kw)
    counts = torch.clamp(counts, min=1.0)
    return (sums / counts[:, None]).to(centroids.dtype)

from .ops import cluster_sums
from .ref import cluster_sums_ref, coclustering_iteration_ref

__all__ = ["cluster_sums", "cluster_sums_ref", "coclustering_iteration_ref"]

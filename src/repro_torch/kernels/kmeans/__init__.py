from .ops import kmeans_assign_reduce, kmeans_iteration
from .ref import kmeans_assign_reduce_ref, kmeans_iteration_ref

__all__ = [
    "kmeans_assign_reduce",
    "kmeans_iteration",
    "kmeans_assign_reduce_ref",
    "kmeans_iteration_ref",
]

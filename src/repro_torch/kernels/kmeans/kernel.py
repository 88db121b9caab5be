"""Launches the K-Means CUDA kernels (``csrc/kmeans.cu``) by one of two
routes.

Each kernel writes one partial per block: sums ``(grid, k, f)`` f32 and
counts ``(grid, k)`` int32.  The caller reduces over the leading axis.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..common import (
    H100_MAX_SHARED_BYTES,
    cdiv,
    check_cuda_tensor,
    resolve_route,
    sm_count,
)

#: blocks per SM of route ``"fma"``'s fixed grid that walks the points
BLOCKS_PER_SM = 4
#: the routes: several points a thread with accumulators private to a
#: thread, and the first kernel, one point a thread and one accumulator a
#: block
ROUTES = ("private", "fma")
#: threads a block of either kernel (``kThreads`` in the source)
THREADS = 256
#: the feature counts route ``"private"`` is compiled for
PRIVATE_FEATURES = (2, 4, 8, 16)


def points_per_thread(f: int) -> int:
    """Route ``"private"``'s points a thread (``thread_points`` in the
    source): as many as keep 64 of its point floats in registers, at most
    16 (16 at f = 4, the best of 1 to 16 in ``tools/cuda_core_probe.py``'s
    sweep on an H100)."""
    return min(16, 64 // f)


def private_shared_bytes(k: int, f: int) -> int:
    """Shared memory of a block of route ``"private"``: the centroids,
    |c|^2 (padded to 4 words) and k (f + 1) accumulator words a thread."""
    return (k * f + -(-k // 4) * 4 + THREADS * k * (f + 1)) * 4


def kmeans_route(points: torch.Tensor, centroids: torch.Tensor) -> str:
    """The kernel a call takes, from shape and alignment alone:
    ``"private"`` for f in ``PRIVATE_FEATURES`` where a thread's
    accumulators fit in a block's shared memory (k (f + 1) up to about 225
    words) and the points are aligned for its vector loads (16 bytes, 8 for
    f = 2); else ``"fma"`` (the first kernel)."""
    k, f = centroids.shape
    align = 8 if f == 2 else 16
    return ("private" if f in PRIVATE_FEATURES and k >= 1
            and private_shared_bytes(k, f) <= H100_MAX_SHARED_BYTES
            and points.data_ptr() % align == 0 else "fma")


_blocks_per_sm: dict[tuple, int] = {}


def private_blocks_per_sm(f: int, k: int) -> int:
    """Blocks of route ``"private"``'s instance an SM holds at once, by the
    CUDA occupancy calculator (its grid is one wave); asked once a process
    for each (f, k)."""
    if (f, k) not in _blocks_per_sm:
        blocks = _build.bind("kmeans_private_blocks_per_sm",
                             [ctypes.c_int] * 2)(f, k)
        if blocks < 1:
            _build.check(-blocks, f"kmeans (private): occupancy at f={f}, "
                         f"k={k}")
            raise RuntimeError(f"kmeans (private): no block of f={f}, k={k} "
                               "fits on an SM")
        _blocks_per_sm[f, k] = blocks
    return _blocks_per_sm[f, k]


def private_grid(n: int, per_thread: int, blocks_per_sm: int,
                 device: torch.device) -> int:
    """Blocks of route ``"private"`` for n points: one wave, or fewer where
    the points run out."""
    return max(1, min(cdiv(n, THREADS * per_thread),
                      blocks_per_sm * sm_count(device.index)))


def kmeans_cuda(
    points: torch.Tensor,  # (n, f) f32, CUDA
    centroids: torch.Tensor,  # (k, f) f32, CUDA
    *,
    route: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-block partials ``(sums (grid,k,f) f32, counts (grid,k) int32)``.

    ``route`` None takes ``kmeans_route``'s choice; ``"fma"`` forces the
    first kernel on inputs route ``"private"`` could take (to time the two
    on the same inputs).  A failed launch raises; no route is tried after
    another fails."""
    check_cuda_tensor("points", points, (torch.float32,), 2)
    check_cuda_tensor("centroids", centroids, (torch.float32,), 2,
                      device=points.device)
    n, f = points.shape
    k, f2 = centroids.shape
    if f != f2 or k < 1 or f < 1:
        raise ValueError(f"shapes disagree: points {tuple(points.shape)}, "
                         f"centroids {tuple(centroids.shape)}")
    route = resolve_route(route, kmeans_route(points, centroids), ROUTES,
                          "kmeans")
    if route == "private":
        part_sums, part_counts, err = _private_partials(points, centroids)
    else:
        part_sums, part_counts, err = _fma_partials(points, centroids)
    kmeans_cuda.launches += 1
    kmeans_cuda.routes[route] += 1
    _build.check(err, f"kmeans ({route})")
    return part_sums, part_counts


def _private_partials(points: torch.Tensor, centroids: torch.Tensor):
    n, f = points.shape
    k = centroids.shape[0]
    grid = private_grid(n, points_per_thread(f), private_blocks_per_sm(f, k),
                        points.device)
    part_sums = torch.empty((grid, k, f), dtype=torch.float32,
                            device=points.device)
    part_counts = torch.empty((grid, k), dtype=torch.int32,
                              device=points.device)
    fn = _build.bind("kmeans_private_partials_f32", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    with torch.cuda.device(points.device):
        err = fn(points.data_ptr(), centroids.data_ptr(),
                 part_sums.data_ptr(), part_counts.data_ptr(), n, f, k, grid,
                 torch.cuda.current_stream().cuda_stream)
    return part_sums, part_counts, err


def _fma_partials(points: torch.Tensor, centroids: torch.Tensor):
    n, f = points.shape
    k = centroids.shape[0]
    if f == 4 and points.data_ptr() % 16:
        raise ValueError("points with 4 features must be 16-byte aligned")
    shared = (2 * k * f + 2 * k) * 4
    if shared > H100_MAX_SHARED_BYTES:
        raise ValueError(
            f"k*f = {k * f} needs {shared} bytes of shared memory, more "
            f"than the {H100_MAX_SHARED_BYTES} a block can have")
    grid = max(1, min(cdiv(n, THREADS),
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
    return part_sums, part_counts, err


#: launches of the CUDA kernels in this process, and by route
kmeans_cuda.launches = 0
kmeans_cuda.routes = dict.fromkeys(ROUTES, 0)

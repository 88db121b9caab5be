"""Launches the N-Body CUDA kernels (``csrc/nbody.cu``) by one of two
routes: ``"tile"``, several targets a thread over slices of the sources
with an unguarded rsqrt, and ``"fma"``, the first kernel, one target a
thread over every source with the accurate ``rsqrtf``."""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..common import check_cuda_tensor, resolve_route
from .ref import SOFTENING2, nbody_slices

#: the routes: several targets a thread, sources in slices; the first kernel
ROUTES = ("tile", "fma")
#: the smallest positive normal float32: route "tile"'s rsqrt is exact only
#: for normal arguments, which every |d|^2 + eps^2 is when eps^2 is one
FLT_MIN = 1.1754943508222875e-38
#: sources a shared-memory tile holds (``kThreads`` in ``csrc/nbody.cu``):
#: route "tile"'s slices are whole tiles
TILE = 256
#: targets a thread in route "tile" (``kTileTargets``), and eps^2 folded
#: into |d|^2's first multiply-add (``kTileFold``)
TILE_TARGETS = 2
TILE_FOLD = True
#: slices of the sources in route "tile": 8 beat 1, 2 and 4 at every
#: number of targets a thread (``tools/cuda_core_probe.py --kernels nbody``)
TILE_SLICES = 8
#: bodies from which route "tile" is taken: on an H100 it was the faster
#: from n = 512 (0.0147 ms against 0.0164) and the slower at 256 (0.0125
#: against 0.0094), where its second pass costs more than it saves
#: (``tools/cuda_core_probe.py --kernels nbody``)
TILE_MIN_N = 512


def nbody_route(posm: torch.Tensor, softening2: float = SOFTENING2) -> str:
    """The route a call takes: ``"tile"`` where eps^2, as the kernel's
    float32, is at least ``FLT_MIN`` and there are ``TILE_MIN_N`` bodies or
    more; ``"fma"`` for the rest (eps^2 = 0, where the self term is NaN
    in the reference too, and a subnormal eps^2, where |d|^2 + eps^2 may be
    subnormal)."""
    eps2 = ctypes.c_float(softening2).value
    if eps2 >= FLT_MIN and posm.shape[0] >= TILE_MIN_N:
        return "tile"
    return "fma"


def nbody_cuda(
    posm: torch.Tensor,  # (n, 4) f32 xyz + mass, CUDA
    *,
    softening2: float = SOFTENING2,
    route: str | None = None,
) -> torch.Tensor:
    """Accelerations (n, 3) f32 into a new tensor.  ``route`` None takes
    ``nbody_route``'s choice; ``"fma"`` forces the first kernel (to time
    the two on the same inputs)."""
    check_cuda_tensor("posm", posm, (torch.float32,), 2)
    n, four = posm.shape
    if four != 4:
        raise ValueError(f"posm must be (n, 4) xyz + mass, got "
                         f"{tuple(posm.shape)}")
    if n >= 2**31 - 4 * TILE:
        raise ValueError(f"{n} bodies: the body index is int32")
    if posm.data_ptr() % 16:
        raise ValueError("posm must be 16-byte aligned (rows are float4)")
    route = resolve_route(route, nbody_route(posm, softening2), ROUTES,
                          "nbody")
    acc = torch.empty((n, 3), dtype=torch.float32, device=posm.device)
    if n == 0:
        return acc
    stream = torch.cuda.current_stream(posm.device).cuda_stream
    if route == "tile":
        slices = nbody_slices(n, TILE_SLICES, TILE)
        partial = (torch.empty((len(slices), n, 3), dtype=torch.float32,
                               device=posm.device)
                   if len(slices) > 1 else acc)
        fn = _build.bind("nbody_tile_f32", [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ])
        with torch.cuda.device(posm.device):
            err = fn(posm.data_ptr(), acc.data_ptr(), partial.data_ptr(), n,
                     softening2, len(slices), slices[0][1] - slices[0][0],
                     stream)
    else:
        fn = _build.bind("nbody_forces_f32", [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
            ctypes.c_void_p,
        ])
        with torch.cuda.device(posm.device):
            err = fn(posm.data_ptr(), acc.data_ptr(), n, softening2, stream)
    nbody_cuda.launches += 1
    nbody_cuda.routes[route] += 1
    _build.check(err, f"nbody route {route}")
    return acc


#: launches of the CUDA kernels in this process, and by route
nbody_cuda.launches = 0
nbody_cuda.routes = dict.fromkeys(ROUTES, 0)

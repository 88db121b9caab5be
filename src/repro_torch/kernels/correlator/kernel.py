"""Launches the correlator CUDA kernels (``csrc/correlator.cu``) by one of
two routes."""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..common import cdiv, check_cuda_tensor, resolve_route

#: the routes: the tiles on and above the diagonal, the rest mirrored; and
#: the first kernel, every tile
ROUTES = ("tri", "fma")
#: antennas a tile side (the kernels' ``TA``)
TILE = 64
#: the kernels' entry point for each route and sample type
ENTRY = {
    "tri": {torch.float32: "correlate_tri_f32",
            torch.bfloat16: "correlate_tri_bf16"},
    "fma": {torch.float32: "correlate_f32", torch.bfloat16: "correlate_bf16"},
}


def tile_pairs(a: int) -> int:
    """Tiles (ti, tj) with ti <= tj of ``a`` antennas: n (n + 1) / 2 for
    n = ceil(a / TILE), the grid of route ``"tri"`` a channel."""
    n = cdiv(a, TILE)
    return n * (n + 1) // 2


def correlate_route(samples: torch.Tensor) -> str:
    """The kernel a call takes, from dtype and shape alone: ``"tri"`` (only
    the tiles with ti <= tj, the others written as their conjugate
    transpose) for f32 and bf16 samples with more than one tile of
    antennas, A > 64; ``"fma"`` (the first kernel) for A <= 64, a single
    tile, where the two do the same work, and for any other type."""
    a = samples.shape[2]
    if samples.dtype in ENTRY["tri"] and a > TILE:
        return "tri"
    return "fma"


def correlate_cuda(samples: torch.Tensor, *,
                   route: str | None = None) -> torch.Tensor:
    """samples (C, T, A, 2) f32 or bf16, CUDA, contiguous → visibilities
    (C, A, A, 2) in the samples' type (summed in f32) in a new tensor.
    Ragged T and A are masked inside the kernel.

    ``route`` None takes ``correlate_route``'s choice; ``"fma"`` forces the
    first kernel on inputs route ``"tri"`` could take (to time the two on
    the same inputs).  A failed launch raises; no route is tried after
    another fails."""
    check_cuda_tensor("samples", samples, tuple(ENTRY["fma"]), 4)
    c, t, a, two = samples.shape
    if two != 2:
        raise ValueError(f"samples must be (C, T, A, 2) re/im pairs, got "
                         f"{tuple(samples.shape)}")
    if c > 65535:
        raise ValueError(f"{c} channels: the kernel's grid takes at most "
                         "65535")
    if (max(c * t * a, c * a * a) >= 2**62 or t >= 2**31 or a >= 2**31
            or tile_pairs(a) >= 2**31):
        raise ValueError(f"too large: C={c}, T={t}, A={a}")
    pair = 2 * samples.element_size()
    if samples.data_ptr() % pair:
        raise ValueError(f"samples must be {pair}-byte aligned (re/im pairs "
                         "are read as one word)")
    route = resolve_route(route, correlate_route(samples), ROUTES,
                          "correlate")
    out = torch.empty((c, a, a, 2), dtype=samples.dtype,
                      device=samples.device)
    if out.numel() == 0:
        return out
    entry = ENTRY[route][samples.dtype]
    stream = torch.cuda.current_stream(samples.device).cuda_stream
    with torch.cuda.device(samples.device):
        if route == "tri":
            fn = _build.bind(entry, [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ])
            err = fn(samples.data_ptr(), out.data_ptr(), c, t, a,
                     tile_pairs(a), stream)
        else:
            fn = _build.bind(entry, [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p,
            ])
            err = fn(samples.data_ptr(), out.data_ptr(), c, t, a, stream)
    correlate_cuda.launches += 1
    correlate_cuda.routes[route] += 1
    _build.check(err, f"correlate ({route})")
    return out


#: launches of the CUDA kernels in this process, and by route
correlate_cuda.launches = 0
correlate_cuda.routes = dict.fromkeys(ROUTES, 0)

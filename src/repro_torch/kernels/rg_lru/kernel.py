"""Launches the RG-LRU CUDA kernels (``csrc/rg_lru.cu``) by one of two
routes."""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..common import cdiv, check_cuda_tensor, resolve_route

_TYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the routes: the recurrence as a scan over chunks of ``CHUNK_LEN`` steps,
#: and the first kernel, one thread walking all T steps of a channel
ROUTES = ("chunk", "fma")
#: steps a chunk of route ``"chunk"``, and the fewest chunks a call takes
#: it from: chosen by ``tools/cuda_core_probe.py``'s sweeps on an H100 (at
#: two chunks, 128 tokens, route ``"fma"`` was still faster)
CHUNK_LEN = 64
MIN_CHUNKS = 3
#: the most chunks route ``"chunk"`` splits T into: each chunk's thread
#: folds the carry of every chunk before it into its outputs pass (reads
#: quadratic in the chunks), so past 64 chunks of ``CHUNK_LEN`` the chunks
#: grow instead
MAX_CHUNKS = 64
#: the most batch rows a grid takes (its y or z extent)
MAX_GRID_YZ = 65535


def rg_lru_route(gx: torch.Tensor, chunk_len: int = CHUNK_LEN) -> str:
    """The kernel a call takes, from shape alone: ``"chunk"`` (the chunked
    scan) where T holds at least ``MIN_CHUNKS`` chunks of ``chunk_len``
    steps, such as recurrentgemma-2b's prefills of 192 tokens and more;
    ``"fma"`` (the first kernel) for shorter T, the decode step (T = 1)
    among them."""
    return "chunk" if gx.shape[1] >= MIN_CHUNKS * chunk_len else "fma"


def chunk_steps(t: int, chunk_len: int = CHUNK_LEN) -> int:
    """Route ``"chunk"``'s steps a chunk for T steps: ``chunk_len``, or
    more where that would give over ``MAX_CHUNKS`` chunks."""
    return max(chunk_len, cdiv(t, MAX_CHUNKS))


def rg_lru_cuda(
    log_a: torch.Tensor,  # (B, T, D) f32 or bf16, CUDA, contiguous
    gx: torch.Tensor,  # (B, T, D) same dtype
    h0: torch.Tensor,  # (B, D) f32
    *,
    route: str | None = None,
    chunk_len: int = CHUNK_LEN,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(every h (B, T, D) in gx's dtype, final h (B, D) f32) in new
    tensors.  Ragged T and D are masked inside the kernels.

    ``route`` None takes ``rg_lru_route``'s choice; ``"fma"`` forces the
    first kernel on inputs route ``"chunk"`` could take (to time the two on
    the same inputs).  ``chunk_len`` sets route ``"chunk"``'s L for a sweep
    (the route is then chosen by that L; ``chunk_steps`` grows it past
    ``MAX_CHUNKS`` chunks).  A failed launch raises; no route is tried
    after another fails."""
    check_cuda_tensor("gx", gx, tuple(_TYPE_CODES), 3)
    check_cuda_tensor("log_a", log_a, (gx.dtype,), 3, device=gx.device)
    check_cuda_tensor("h0", h0, (torch.float32,), 2, device=gx.device)
    b, t, d = gx.shape
    if log_a.shape != gx.shape or h0.shape != (b, d):
        raise ValueError(f"shapes disagree: log_a {tuple(log_a.shape)}, "
                         f"gx {tuple(gx.shape)}, h0 {tuple(h0.shape)}")
    if b > MAX_GRID_YZ or b * t * d >= 2**62 or t >= 2**31 or d >= 2**31:
        raise ValueError(f"too large: B={b}, T={t}, D={d}")
    if chunk_len < 1:
        raise ValueError(f"chunk_len {chunk_len}: a chunk is at least a step")
    route = resolve_route(route, rg_lru_route(gx, chunk_len), ROUTES,
                          "rg_lru")
    out = torch.empty_like(gx)
    if b * d == 0 or t == 0:
        return out, h0.clone()
    h_final = torch.empty_like(h0)
    stream = torch.cuda.current_stream(gx.device).cuda_stream
    args = (log_a.data_ptr(), gx.data_ptr(), h0.data_ptr(), out.data_ptr(),
            h_final.data_ptr())
    with torch.cuda.device(gx.device):
        if route == "chunk":
            length = chunk_steps(t, chunk_len)
            chunks = cdiv(t, length)
            hloc = torch.empty((b, chunks, d), dtype=torch.float32,
                               device=gx.device)
            decay = torch.empty_like(hloc)
            fn = _build.bind("rg_lru_chunk_fwd", [ctypes.c_void_p] * 7 + [
                ctypes.c_int] * 5 + [ctypes.c_void_p])
            err = fn(*args, hloc.data_ptr(), decay.data_ptr(), b, t, d,
                     length, _TYPE_CODES[gx.dtype], stream)
        else:
            fn = _build.bind("rg_lru_fwd", [ctypes.c_void_p] * 5 + [
                ctypes.c_int] * 4 + [ctypes.c_void_p])
            err = fn(*args, b, t, d, _TYPE_CODES[gx.dtype], stream)
    rg_lru_cuda.launches += 1
    rg_lru_cuda.routes[route] += 1
    _build.check(err, f"rg_lru ({route})")
    return out, h_final


#: launches of the CUDA kernels in this process (one a call, whatever the
#: route launches), and by route
rg_lru_cuda.launches = 0
rg_lru_cuda.routes = dict.fromkeys(ROUTES, 0)

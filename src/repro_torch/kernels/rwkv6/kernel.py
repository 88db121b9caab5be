"""Launches the WKV6 CUDA kernels (``csrc/wkv6.cu``) by one of two routes."""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..common import cdiv, check_cuda_tensor, resolve_route

_TYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the kernel's limits: key dims a head (its state column lives in
#: registers) and value dims a head (one thread each)
MAX_K = 64
MAX_V = 64
#: the routes: the recurrence as a scan over chunks of ``CHUNK_LEN`` steps
#: (three launches), and the first kernel, all T steps in one block
ROUTES = ("chunk", "fma")
#: steps a chunk of route ``"chunk"`` (chosen by ``tools/cuda_core_probe.py``'s
#: sweep on an H100)
CHUNK_LEN = 64


def wkv6_route(r: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel a call takes, from shape alone: ``"chunk"`` (the chunked
    scan) where T holds at least two chunks of ``CHUNK_LEN`` steps, such as
    rwkv6-3b's prefills of 128 tokens and more; ``"fma"`` (the first
    kernel, one block walking all T steps) for shorter T, the decode step
    (T = 1) among them."""
    del v  # K and V are bounded alike for both routes
    return "chunk" if r.shape[2] >= 2 * CHUNK_LEN else "fma"


def wkv6_cuda(
    r: torch.Tensor,  # (B, H, T, K) f32 or bf16, CUDA, contiguous
    k: torch.Tensor,  # (B, H, T, K) same dtype
    v: torch.Tensor,  # (B, H, T, V) same dtype
    w: torch.Tensor,  # (B, H, T, K) same dtype, decay in (0, 1)
    u: torch.Tensor,  # (H, K) f32
    s0: torch.Tensor,  # (B, H, K, V) f32
    *,
    route: str | None = None,
    chunk_len: int = CHUNK_LEN,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(out (B, H, T, V) in r's dtype, final state (B, H, K, V) f32) in new
    tensors.  Ragged T is masked inside the kernels.

    ``route`` None takes ``wkv6_route``'s choice; ``"fma"`` forces the first
    kernel on inputs route ``"chunk"`` could take (to time the two on the
    same inputs).  ``chunk_len`` sets route ``"chunk"``'s L for a sweep
    (any L from 1 on; the route is chosen by ``CHUNK_LEN``).  A failed
    launch raises; no route is tried after another fails."""
    check_cuda_tensor("r", r, tuple(_TYPE_CODES), 4)
    for name, x in (("k", k), ("v", v), ("w", w)):
        check_cuda_tensor(name, x, (r.dtype,), 4, device=r.device)
    check_cuda_tensor("u", u, (torch.float32,), 2, device=r.device)
    check_cuda_tensor("s0", s0, (torch.float32,), 4, device=r.device)
    b, h, t, dk = r.shape
    dv = v.shape[-1]
    if (k.shape != r.shape or w.shape != r.shape
            or v.shape != (b, h, t, dv) or u.shape != (h, dk)
            or s0.shape != (b, h, dk, dv)):
        raise ValueError(f"shapes disagree: r {tuple(r.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"w {tuple(w.shape)}, u {tuple(u.shape)}, "
                         f"s0 {tuple(s0.shape)}")
    if not (1 <= dk <= MAX_K and 1 <= dv <= MAX_V):
        raise ValueError(f"K={dk}, V={dv}: the kernel takes 1 to {MAX_K} "
                         f"key and 1 to {MAX_V} value dims a head")
    if b * h >= 2**31 or b * h * t * max(dk, dv) >= 2**62 or t >= 2**31:
        raise ValueError(f"too large: B={b}, H={h}, T={t}")
    if chunk_len < 1:
        raise ValueError(f"chunk_len {chunk_len}: a chunk is at least a step")
    route = resolve_route(route, wkv6_route(r, v), ROUTES, "wkv6")
    out = torch.empty((b, h, t, dv), dtype=r.dtype, device=r.device)
    if b * h == 0:
        return out, s0.clone()
    s_final = torch.empty_like(s0)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    args = (r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), s0.data_ptr(), out.data_ptr(), s_final.data_ptr())
    with torch.cuda.device(r.device):
        if route == "chunk":
            chunks = cdiv(t, chunk_len)
            states = torch.empty((b, h, chunks, dk, dv), dtype=torch.float32,
                                 device=r.device)
            decays = torch.empty((b, h, chunks, dk), dtype=torch.float32,
                                 device=r.device)
            fn = _build.bind("wkv6_chunk_fwd", [ctypes.c_void_p] * 10 + [
                ctypes.c_int] * 7 + [ctypes.c_void_p])
            err = fn(*args, states.data_ptr(), decays.data_ptr(), b, h, t,
                     dk, dv, chunk_len, _TYPE_CODES[r.dtype], stream)
        else:
            fn = _build.bind("wkv6_fwd", [ctypes.c_void_p] * 8 + [
                ctypes.c_int] * 6 + [ctypes.c_void_p])
            err = fn(*args, b, h, t, dk, dv, _TYPE_CODES[r.dtype], stream)
    wkv6_cuda.launches += 1
    wkv6_cuda.routes[route] += 1
    _build.check(err, f"wkv6 ({route})")
    return out, s_final


#: launches of the CUDA kernels in this process (one a call, whatever the
#: route launches), and by route
wkv6_cuda.launches = 0
wkv6_cuda.routes = dict.fromkeys(ROUTES, 0)

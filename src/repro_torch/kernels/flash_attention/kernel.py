"""Launches the flash-attention CUDA kernels (``csrc/flash_attention.cu``)
by one of two routes."""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..common import check_cuda_tensor, resolve_route

_TYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the routes: the tensor cores fed by TMA, and the first kernel (CUDA cores)
ROUTES = ("wgmma", "fma")
#: head dims the kernels take: up to 256, a multiple of 8 (16-byte rows)
MAX_HEAD_DIM = 256


def flash_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel a call takes, from dtype, shape and alignment alone.

    ``"wgmma"`` (tensor cores fed by TMA) for bf16 inputs with head dims up
    to 256 in multiples of 8 (16-byte rows, which TMA can describe),
    16-byte-aligned bases and at least one key.  ``"fma"`` (the CUDA cores)
    for the rest: f32 inputs, which are held at 2e-4 (bf16 operands cannot
    meet that), and a call with no keys."""
    d, t = q.shape[-1], k.shape[2]
    if (q.dtype == k.dtype == v.dtype == torch.bfloat16 and d % 8 == 0
            and d <= MAX_HEAD_DIM and t > 0
            and all(x.data_ptr() % 16 == 0 for x in (q, k, v))):
        return "wgmma"
    return "fma"


def flash_attention_cuda(
    q: torch.Tensor,  # (B, HQ, S, D) f32 or bf16, CUDA, contiguous
    k: torch.Tensor,  # (B, HKV, T, D) same dtype
    v: torch.Tensor,  # (B, HKV, T, D) same dtype
    *,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
    q_offset: int = 0,
    route: str | None = None,
) -> torch.Tensor:
    """Attention output (B, HQ, S, D) in q's dtype into a new tensor.
    Ragged S and T are masked inside the kernels; nothing is padded.
    ``route`` None takes ``flash_route``'s choice; ``"fma"`` forces the CUDA
    cores' kernel on inputs the tensor cores could take (to time the two on
    the same inputs).  A failed launch raises; no route is tried after
    another fails."""
    check_cuda_tensor("q", q, tuple(_TYPE_CODES), 4)
    check_cuda_tensor("k", k, (q.dtype,), 4, device=q.device)
    check_cuda_tensor("v", v, (q.dtype,), 4, device=q.device)
    b, hq, s, d = q.shape
    bk, hkv, t, dk = k.shape
    if v.shape != k.shape or bk != b or dk != d:
        raise ValueError(f"shapes disagree: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"{hq} query heads are not a multiple of {hkv} "
                         "kv heads")
    if d > MAX_HEAD_DIM or d % 8:
        raise ValueError(f"head_dim {d}: the kernel takes a multiple of 8 "
                         f"up to {MAX_HEAD_DIM}")
    if window is not None and window < 1:
        raise ValueError(f"window {window} lets no key through")
    if max(b * hq * s, b * hkv * t) * d >= 2**62 or hq > 65535 or b > 65535:
        raise ValueError(f"grid too large: B={b}, HQ={hq}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    route = resolve_route(route, flash_route(q, k, v), ROUTES,
                          "flash attention")
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq,
            hkv, s, t, d, int(causal), 0 if window is None else int(window),
            float(scale), int(q_offset)]
    argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_int,
    ]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        if route == "wgmma":
            fn = _build.bind("flash_attention_wgmma",
                             argtypes + [ctypes.c_void_p])
            err = fn(*args, stream)
        else:
            fn = _build.bind("flash_attention_fwd",
                             argtypes + [ctypes.c_int, ctypes.c_void_p])
            err = fn(*args, _TYPE_CODES[q.dtype], stream)
    flash_attention_cuda.launches += 1
    flash_attention_cuda.routes[route] += 1
    _build.check(err, f"flash attention ({route})")
    return out


#: launches of the CUDA kernels in this process, and by route
flash_attention_cuda.launches = 0
flash_attention_cuda.routes = dict.fromkeys(ROUTES, 0)

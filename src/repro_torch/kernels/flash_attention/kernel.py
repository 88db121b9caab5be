"""Launches the flash-attention CUDA kernel (``csrc/flash_attention.cu``)."""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..common import check_cuda_tensor

_TYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: head dims the kernel takes: up to 256, a multiple of 8 (16-byte rows)
MAX_HEAD_DIM = 256


def flash_attention_cuda(
    q: torch.Tensor,  # (B, HQ, S, D) f32 or bf16, CUDA, contiguous
    k: torch.Tensor,  # (B, HKV, T, D) same dtype
    v: torch.Tensor,  # (B, HKV, T, D) same dtype
    *,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Attention output (B, HQ, S, D) in q's dtype into a new tensor.
    Ragged S and T are masked inside the kernel; nothing is padded."""
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
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = _build.bind("flash_attention_fwd", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ])
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, hq, hkv, s, t, d, int(causal),
                 0 if window is None else int(window), float(scale),
                 int(q_offset), _TYPE_CODES[q.dtype],
                 torch.cuda.current_stream().cuda_stream)
    flash_attention_cuda.launches += 1
    _build.check(err, "flash_attention_fwd")
    return out


#: launches of the CUDA kernel in this process
flash_attention_cuda.launches = 0

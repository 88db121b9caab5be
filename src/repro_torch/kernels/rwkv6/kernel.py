"""Launches the WKV6 CUDA kernel (``csrc/wkv6.cu``)."""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..common import check_cuda_tensor

_TYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the kernel's limits: key dims a head (its state column lives in
#: registers) and value dims a head (one thread each)
MAX_K = 64
MAX_V = 64


def wkv6_cuda(
    r: torch.Tensor,  # (B, H, T, K) f32 or bf16, CUDA, contiguous
    k: torch.Tensor,  # (B, H, T, K) same dtype
    v: torch.Tensor,  # (B, H, T, V) same dtype
    w: torch.Tensor,  # (B, H, T, K) same dtype, decay in (0, 1)
    u: torch.Tensor,  # (H, K) f32
    s0: torch.Tensor,  # (B, H, K, V) f32
) -> tuple[torch.Tensor, torch.Tensor]:
    """(out (B, H, T, V) in r's dtype, final state (B, H, K, V) f32) in new
    tensors.  Ragged T is masked inside the kernel."""
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
    out = torch.empty((b, h, t, dv), dtype=r.dtype, device=r.device)
    if b * h == 0:
        return out, s0.clone()
    s_final = torch.empty_like(s0)
    fn = _build.bind("wkv6_fwd", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ])
    with torch.cuda.device(r.device):
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), s0.data_ptr(), out.data_ptr(),
                 s_final.data_ptr(), b, h, t, dk, dv, _TYPE_CODES[r.dtype],
                 torch.cuda.current_stream().cuda_stream)
    wkv6_cuda.launches += 1
    _build.check(err, "wkv6_fwd")
    return out, s_final


#: launches of the CUDA kernel in this process
wkv6_cuda.launches = 0

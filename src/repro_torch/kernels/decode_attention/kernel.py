"""Launches the decode-attention CUDA kernel (``csrc/decode_attention.cu``)."""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..common import cdiv, check_cuda_tensor, sm_count

_TYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: keys per tile of the kernel (its ``BT``)
TILE = 64
#: the kernel's limits: query heads a block takes, and their outputs
MAX_GROUP = 64
MAX_GROUP_X_DIM = 4096
#: blocks to aim for on each SM when the cache is split over blocks: a
#: block works through its tiles one after another (load, sync, compute),
#: so more and shorter splits keep more loads in flight on each SM.  On an
#: H100 (``tools/decode_splits.py``) phi3-mini's decode shape (256 blocks
#: unsplit) took 0.176 ms in one split, 0.062 in 5 (8 an SM), 0.059 in 9
#: (16 an SM) and 0.067 in 35; gemma-2b's (8 blocks) 0.80 ms in one split
#: and 0.054 in 35.
BLOCKS_PER_SM = 16


def split_plan(batch: int, kv_heads: int, t: int,
               device: torch.device) -> tuple[int, int]:
    """(splits, tiles a split): enough blocks for ``BLOCKS_PER_SM`` on each
    SM, in whole tiles, no split empty for a full-length row."""
    tiles = cdiv(t, TILE)
    want = cdiv(BLOCKS_PER_SM * sm_count(device.index), batch * kv_heads)
    splits = max(1, min(tiles, want))
    per_split = cdiv(tiles, splits)
    return cdiv(tiles, per_split), per_split


def decode_attention_cuda(
    q: torch.Tensor,  # (B, HQ, D) f32 or bf16, CUDA, contiguous
    k: torch.Tensor,  # (B, HKV, T, D) same dtype
    v: torch.Tensor,  # (B, HKV, T, D) same dtype
    kv_len: torch.Tensor,  # (B,) int32 on q's device
    *,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(out (B, HQ, D) in q's dtype, lse (B, HQ) f32) into new tensors.
    Keys at and past ``kv_len[b]`` are neither read nor counted."""
    check_cuda_tensor("q", q, tuple(_TYPE_CODES), 3)
    check_cuda_tensor("k", k, (q.dtype,), 4, device=q.device)
    check_cuda_tensor("v", v, (q.dtype,), 4, device=q.device)
    check_cuda_tensor("kv_len", kv_len, (torch.int32,), 1, device=q.device)
    b, hq, d = q.shape
    bk, hkv, t, dk = k.shape
    if v.shape != k.shape or bk != b or dk != d or kv_len.shape[0] != b:
        raise ValueError(f"shapes disagree: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"kv_len {tuple(kv_len.shape)}")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"{hq} query heads are not a multiple of {hkv} "
                         "kv heads")
    group = hq // hkv
    vec = 16 // q.element_size()
    if d == 0 or d % vec:
        raise ValueError(f"head_dim {d}: the kernel takes a multiple of "
                         f"{vec} for {q.dtype}")
    if group > MAX_GROUP or group * d > MAX_GROUP_X_DIM:
        raise ValueError(f"{group} query heads of {d} dims a kv head: the "
                         f"kernel takes at most {MAX_GROUP} and "
                         f"{MAX_GROUP_X_DIM} outputs")
    if b > 65535 or hkv > 65535 or b * hkv * t * d >= 2**62:
        raise ValueError(f"grid too large: B={b}, HKV={hkv}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    out = torch.empty_like(q)
    lse = torch.empty((b, hq), dtype=torch.float32, device=q.device)
    if out.numel() == 0 or t == 0:
        out.zero_()
        lse.fill_(-1e30)
        return out, lse
    splits, per_split = split_plan(b, hkv, t, q.device)
    parts = (None, None, None)
    if splits > 1:
        # One scratch allocation: each split's accumulator (b*hq, splits,
        # d), then its m and its l (b*hq, splits), f32.
        rows = b * hq * splits
        scratch = torch.empty(rows * (d + 2), dtype=torch.float32,
                              device=q.device)
        acc = scratch.data_ptr()
        parts = (acc, acc + 4 * rows * d, acc + 4 * rows * (d + 1))
    fn = _build.bind("decode_attention_fwd", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ])
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
                 out.data_ptr(), lse.data_ptr(), *parts, b, hkv, group, t, d,
                 splits, per_split, float(scale), _TYPE_CODES[q.dtype],
                 torch.cuda.current_stream().cuda_stream)
    decode_attention_cuda.launches += 1
    _build.check(err, "decode_attention_fwd")
    return out, lse


#: launches of the CUDA kernel in this process
decode_attention_cuda.launches = 0

"""Launches the decode-attention CUDA kernels by one of two routes: on a
cache in q's dtype (``csrc/decode_attention.cu``) and on an int8 cache with
per-token scales (``csrc/decode_attention_int8.cu``)."""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..common import cdiv, check_cuda_tensor, resolve_route, sm_count

_TYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the routes: the group's query heads on the tensor cores (mma.sync) fed by
#: a cp.async ring, and the first kernel (CUDA cores)
ROUTES = ("mma", "fma")
#: keys per tile of both kernels (their ``BT``)
TILE = 64
#: the kernels' limits: query heads a block takes, and their outputs (for
#: route "mma", the group padded to 16, 32 or 64 rows)
MAX_GROUP = 64
MAX_GROUP_X_DIM = 4096
#: blocks to aim for on each SM when the cache is split over blocks, by
#: route.  "fma": a block works through its tiles one after another (load,
#: sync, compute), so more and shorter splits keep more loads in flight on
#: each SM.  On an H100 (``tools/decode_splits.py``) phi3-mini's decode
#: shape (256 blocks unsplit) took 0.176 ms in one split, 0.062 in 5 (8 an
#: SM), 0.059 in 9 (16 an SM) and 0.067 in 35; gemma-2b's (8 blocks) 0.80 ms
#: in one split and 0.054 in 35.  "mma" keeps two or three tiles in flight a
#: block, so it aims at 2 blocks an SM and splits into at least
#: ``MMA_TILES_PER_SPLIT[0]`` and at most ``[1]`` tiles: on an H100
#: (``tools/decode_splits.py``, kv_len over [1, T], two draws, NVIDIA H100
#: 80GB HBM3 at 700 W) phi3-mini's shape took 0.059-0.064 ms in one split,
#: 0.053-0.062 in 2, 0.049-0.055 in 5 (7 tiles), 0.048-0.056 in 9 and
#: 0.072-0.085 in 35; gemma-2b's 0.097 in one, 0.022 in 9, 0.020 in 18 (2
#: tiles) and 0.023-0.028 in 35; recurrentgemma-2b's 0.090 in one, 0.0195 in
#: 16 (2 tiles) and 0.022-0.028 in 32 (1 tile).
BLOCKS_PER_SM = {"fma": 16, "mma": 2}
MMA_TILES_PER_SPLIT = (2, 7)


def _mma_rows(group: int) -> int:
    """Rows route "mma" pads a group of query heads to (one, two or four
    m16 tiles)."""
    return 16 if group <= 16 else 32 if group <= 32 else 64


def _mma_takes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Route "mma" takes a bf16 q with a head dim that is a multiple of 16,
    at most 64 query heads a kv head, the padded rows times the head dim at
    most 4096, and 16-byte-aligned bases."""
    d, hq, hkv = q.shape[-1], q.shape[1], k.shape[1]
    group = hq // hkv if hkv and hq % hkv == 0 else 0
    return (q.dtype == torch.bfloat16 and d > 0 and d % 16 == 0
            and 0 < group <= MAX_GROUP
            and _mma_rows(group) * d <= MAX_GROUP_X_DIM
            and all(x.data_ptr() % 16 == 0 for x in (q, k, v)))


def decode_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel a call takes, from dtype, shape and alignment alone.

    ``"mma"`` (the group's query heads on the tensor cores, padded to 16,
    32 or 64 rows) for bf16 inputs that ``_mma_takes``.  ``"fma"`` (the
    first kernel) for everything else: f32 inputs, which are held at 2e-4
    (bf16 operands cannot meet that), and bf16 shapes such as D = 40."""
    return "mma" if k.dtype == v.dtype == q.dtype and _mma_takes(q, k, v) \
        else "fma"


def decode_quant_route(q: torch.Tensor, k_q: torch.Tensor,
                       v_q: torch.Tensor) -> str:
    """The int8 cache's kernel a call takes, as ``decode_route`` chooses:
    ``"mma"`` (each warp's int8 keys and values widened to bf16 in shared
    memory, then the group's query heads on the tensor cores) for a bf16 q
    and an int8 cache that ``_mma_takes``; ``"fma"`` for the rest: f32 q,
    held at 2e-4, and shapes such as D = 40."""
    return "mma" if k_q.dtype == v_q.dtype == torch.int8 \
        and _mma_takes(q, k_q, v_q) else "fma"


def split_plan(batch: int, kv_heads: int, t: int, device: torch.device,
               route: str = "fma") -> tuple[int, int]:
    """(splits, tiles a split): enough blocks for the route's
    ``BLOCKS_PER_SM`` on each SM, in whole tiles, no split empty for a
    full-length row; for route "mma" also within ``MMA_TILES_PER_SPLIT``
    tiles a split (fewer where the cache has fewer)."""
    tiles = cdiv(t, TILE)
    want = cdiv(BLOCKS_PER_SM[route] * sm_count(device.index),
                batch * kv_heads)
    fewest, most = MMA_TILES_PER_SPLIT if route == "mma" else (1, tiles)
    splits = max(1, min(tiles, max(want, cdiv(tiles, most))))
    per_split = max(cdiv(tiles, splits), min(fewest, tiles))
    return cdiv(tiles, per_split), per_split


def _check_sizes(b: int, hq: int, hkv: int, t: int, d: int, vec: int,
                 what: str) -> None:
    """Raise on sizes the kernels do not take: a group of query heads that
    is not whole or too large, a head dim that is not a multiple of
    ``vec``, a grid too large."""
    if hkv == 0 or hq % hkv:
        raise ValueError(f"{hq} query heads are not a multiple of {hkv} "
                         "kv heads")
    group = hq // hkv
    if d == 0 or d % vec:
        raise ValueError(f"head_dim {d}: the kernel takes a multiple of "
                         f"{vec} {what}")
    if group > MAX_GROUP or group * d > MAX_GROUP_X_DIM:
        raise ValueError(f"{group} query heads of {d} dims a kv head: the "
                         f"kernel takes at most {MAX_GROUP} and "
                         f"{MAX_GROUP_X_DIM} outputs")
    if b > 65535 or hkv > 65535 or b * hkv * t * d >= 2**62:
        raise ValueError(f"grid too large: B={b}, HKV={hkv}")


def _attend(symbols: tuple[str, str], route: str, q: torch.Tensor,
            cache: tuple, kv_len: torch.Tensor, hkv: int, t: int,
            scale: float | None
            ) -> tuple[torch.Tensor, torch.Tensor, int | None]:
    """(out, lse, the launcher's error code) of one launch of route
    ``route``'s C entry point (``symbols``: route "mma"'s, then route
    "fma"'s, which also takes q's type) on ``cache`` (its tensors, in the
    entry point's order), into new tensors, with the splits' scratch; an
    empty q or cache gives zeros and lse -1e30 and launches nothing
    (error code None)."""
    b, hq, d = q.shape
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    out = torch.empty_like(q)
    lse = torch.empty((b, hq), dtype=torch.float32, device=q.device)
    if out.numel() == 0 or t == 0:
        out.zero_()
        lse.fill_(-1e30)
        return out, lse, None
    splits, per_split = split_plan(b, hkv, t, q.device, route)
    parts = (None, None, None)
    if splits > 1:
        # One scratch allocation: each split's accumulator (b*hq, splits,
        # d), then its m and its l (b*hq, splits), f32.
        rows = b * hq * splits
        scratch = torch.empty(rows * (d + 2), dtype=torch.float32,
                              device=q.device)
        acc = scratch.data_ptr()
        parts = (acc, acc + 4 * rows * d, acc + 4 * rows * (d + 1))
    args = [x.data_ptr() for x in (q, *cache, kv_len, out, lse)] + [*parts]
    argtypes = [ctypes.c_void_p] * len(args) + [ctypes.c_int] * 7 \
        + [ctypes.c_float]
    sizes = [b, hkv, hq // hkv, t, d, splits, per_split]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        if route == "mma":
            fn = _build.bind(symbols[0], argtypes + [ctypes.c_void_p])
            err = fn(*args, *sizes, float(scale), stream)
        else:
            fn = _build.bind(symbols[1], argtypes + [ctypes.c_int,
                                                     ctypes.c_void_p])
            err = fn(*args, *sizes, float(scale), _TYPE_CODES[q.dtype],
                     stream)
    return out, lse, err


def decode_attention_cuda(
    q: torch.Tensor,  # (B, HQ, D) f32 or bf16, CUDA, contiguous
    k: torch.Tensor,  # (B, HKV, T, D) same dtype
    v: torch.Tensor,  # (B, HKV, T, D) same dtype
    kv_len: torch.Tensor,  # (B,) int32 on q's device
    *,
    scale: float | None = None,
    route: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(out (B, HQ, D) in q's dtype, lse (B, HQ) f32) into new tensors.
    Keys at and past ``kv_len[b]`` are neither read nor counted.
    ``route`` None takes ``decode_route``'s choice; ``"fma"`` forces the
    first kernel on inputs the tensor cores could take (to time the two on
    the same inputs).  A failed launch raises; no route is tried after
    another fails."""
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
    vec = 16 // q.element_size()
    _check_sizes(b, hq, hkv, t, d, vec, f"for {q.dtype}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    route = resolve_route(route, decode_route(q, k, v), ROUTES,
                          "decode attention")
    out, lse, err = _attend(("decode_attention_mma", "decode_attention_fwd"),
                            route, q, (k, v), kv_len, hkv, t, scale)
    if err is None:
        return out, lse
    decode_attention_cuda.launches += 1
    decode_attention_cuda.routes[route] += 1
    _build.check(err, f"decode attention ({route})")
    return out, lse


#: launches of the CUDA kernels in this process, and by route
decode_attention_cuda.launches = 0
decode_attention_cuda.routes = dict.fromkeys(ROUTES, 0)


def decode_attention_quant_cuda(
    q: torch.Tensor,  # (B, HQ, D) f32 or bf16, CUDA, contiguous
    k_q: torch.Tensor,  # (B, HKV, T, D) int8
    k_s: torch.Tensor,  # (B, HKV, T) f32 per-token scales
    v_q: torch.Tensor,  # (B, HKV, T, D) int8
    v_s: torch.Tensor,  # (B, HKV, T) f32
    kv_len: torch.Tensor,  # (B,) int32 on q's device
    *,
    scale: float | None = None,
    route: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Decode attention on the int8 cache: (out (B, HQ, D) in q's dtype,
    lse (B, HQ) f32) into new tensors, the scales folded into the two
    products.  Keys at and past ``kv_len[b]`` are neither read nor
    counted.  ``route`` None takes ``decode_quant_route``'s choice;
    ``"fma"`` forces the first kernel.  A failed launch raises; no route is
    tried after another fails."""
    check_cuda_tensor("q", q, tuple(_TYPE_CODES), 3)
    for name, x in (("k_q", k_q), ("v_q", v_q)):
        check_cuda_tensor(name, x, (torch.int8,), 4, device=q.device)
    for name, x in (("k_s", k_s), ("v_s", v_s)):
        check_cuda_tensor(name, x, (torch.float32,), 3, device=q.device)
    check_cuda_tensor("kv_len", kv_len, (torch.int32,), 1, device=q.device)
    b, hq, d = q.shape
    bk, hkv, t, dk = k_q.shape
    if (v_q.shape != k_q.shape or k_s.shape != (bk, hkv, t)
            or v_s.shape != k_s.shape or bk != b or dk != d
            or kv_len.shape[0] != b):
        raise ValueError(f"shapes disagree: q {tuple(q.shape)}, "
                         f"k_q {tuple(k_q.shape)}, k_s {tuple(k_s.shape)}, "
                         f"v_q {tuple(v_q.shape)}, v_s {tuple(v_s.shape)}, "
                         f"kv_len {tuple(kv_len.shape)}")
    _check_sizes(b, hq, hkv, t, d, 4, "for an int8 cache")
    for name, x in (("k_q", k_q), ("v_q", v_q)):
        if x.data_ptr() % 4:
            raise ValueError(f"{name} must be 4-byte aligned")
    route = resolve_route(route, decode_quant_route(q, k_q, v_q), ROUTES,
                          "decode attention on the int8 cache")
    out, lse, err = _attend(
        ("decode_attention_int8_mma", "decode_attention_int8_fwd"), route, q,
        (k_q, k_s, v_q, v_s), kv_len, hkv, t, scale)
    if err is None:
        return out, lse
    decode_attention_quant_cuda.launches += 1
    decode_attention_quant_cuda.routes[route] += 1
    _build.check(err, f"decode attention on the int8 cache ({route})")
    return out, lse


#: launches of the int8 cache's CUDA kernels in this process, and by route
decode_attention_quant_cuda.launches = 0
decode_attention_quant_cuda.routes = dict.fromkeys(ROUTES, 0)

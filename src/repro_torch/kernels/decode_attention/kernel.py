"""Launches the decode-attention CUDA kernels: on a cache in q's dtype
(``csrc/decode_attention.cu``, by one of two routes) and on an int8 cache
with per-token scales (by one of three: ``csrc/decode_attention_int8_gemv.cu``
and ``csrc/decode_attention_int8.cu``)."""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..common import cdiv, check_cuda_tensor, resolve_route, sm_count

_TYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the routes on a cache in q's dtype: the group's query heads on the tensor
#: cores (mma.sync) fed by a cp.async ring, and the first kernel (CUDA
#: cores)
ROUTES = ("mma", "fma")
#: the int8 cache's routes: a small group's query heads on the CUDA cores,
#: each lane's int8 bytes widened in registers, fed by a ring of bulk copies
#: ("gemv"); then the two above, on int8 keys and values widened to bf16 in
#: shared memory ("mma") or read as 4-byte words ("fma")
QUANT_ROUTES = ("gemv", "mma", "fma")
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
#: Route "gemv" (the int8 cache) fits 4 blocks an SM at D = 128 and aims
#: at them, within ``GEMV_TILES_PER_SPLIT`` tiles a split: on an H100
#: (``tools/decode_splits.py --int8 --route gemv``, two draws, NVIDIA H100
#: 80GB HBM3 at 700 W) qwen1.5-32b's decode shape took 0.059-0.061 ms in
#: one split, 0.052-0.054 in 2, 0.050-0.057 in 5 (7 tiles, the plan),
#: 0.052-0.056 in 9 and 0.061-0.064 in 35; its rank's run 0.016-0.018 in
#: 1-5 splits (the plan 2) and 0.018-0.020 in 9.
BLOCKS_PER_SM = {"fma": 16, "mma": 2, "gemv": 4}
MMA_TILES_PER_SPLIT = (2, 7)
GEMV_TILES_PER_SPLIT = (2, 8)
#: head dims route "gemv" takes: 16 bytes of a key row a lane, so 4, 8 or
#: 16 lanes a row and a warp's 32 lanes on whole rows
GEMV_DIMS = (64, 128, 256)
#: The largest group route "gemv" takes: the crossover with route "mma" at
#: D = 128 (``tools/decode_splits.py --int8 --route gemv``, 48 query heads
#: over 8 slots, T = 2184, NVIDIA H100 80GB HBM3 at 700 W): "gemv" against
#: "mma" 0.041 against 0.070 ms at a group of 1, 0.035 against 0.050 at 2,
#: 0.026 against 0.033 at 4, 0.029 against 0.027 at 6 and 0.025 against
#: 0.025 at 8 (a build with 8 heads, which spills).  Each lane holds 16
#: columns of every head's query and its accumulators in registers; the
#: package builds 1, 2 and 4 heads.
GEMV_MAX_GROUP = 4


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


def _gemv_takes(q: torch.Tensor, k_q: torch.Tensor,
                v_q: torch.Tensor) -> bool:
    """Route "gemv" takes a bf16 q with a head dim of ``GEMV_DIMS``, at
    most ``GEMV_MAX_GROUP`` query heads a kv head, and 16-byte-aligned
    bases."""
    d, hq, hkv = q.shape[-1], q.shape[1], k_q.shape[1]
    group = hq // hkv if hkv and hq % hkv == 0 else 0
    return (q.dtype == torch.bfloat16 and d in GEMV_DIMS
            and 0 < group <= GEMV_MAX_GROUP
            and all(x.data_ptr() % 16 == 0 for x in (q, k_q, v_q)))


def decode_quant_route(q: torch.Tensor, k_q: torch.Tensor,
                       v_q: torch.Tensor) -> str:
    """The int8 cache's kernel a call takes, from dtype, shape and
    alignment alone: ``"gemv"`` (a small group's query heads on the CUDA
    cores, the int8 bytes widened in registers) for a bf16 q and an int8
    cache that ``_gemv_takes``, as qwen1.5-32b's decode (a group of 1 at D
    = 128) and its rank's run of a cache split by sequence; ``"mma"`` (each
    warp's int8 keys and values widened to bf16 in shared memory, then the
    group's query heads on the tensor cores) for the other bf16 shapes that
    ``_mma_takes``, as larger groups and D = 80; ``"fma"`` for the rest:
    f32 q, held at 2e-4, and shapes such as D = 40."""
    if k_q.dtype != torch.int8 or v_q.dtype != torch.int8:
        return "fma"
    if _gemv_takes(q, k_q, v_q):
        return "gemv"
    return "mma" if _mma_takes(q, k_q, v_q) else "fma"


#: tiles a split, at least and at most, by route
_TILES_PER_SPLIT = {"mma": MMA_TILES_PER_SPLIT, "gemv": GEMV_TILES_PER_SPLIT}


def split_plan(batch: int, kv_heads: int, t: int, device: torch.device,
               route: str = "fma") -> tuple[int, int]:
    """(splits, tiles a split): enough blocks for the route's
    ``BLOCKS_PER_SM`` on each SM, in whole tiles, no split empty for a
    full-length row; for routes "mma" and "gemv" also within
    ``MMA_TILES_PER_SPLIT`` or ``GEMV_TILES_PER_SPLIT`` tiles a split
    (fewer where the cache has fewer)."""
    tiles = cdiv(t, TILE)
    want = cdiv(BLOCKS_PER_SM[route] * sm_count(device.index),
                batch * kv_heads)
    fewest, most = _TILES_PER_SPLIT.get(route, (1, tiles))
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


#: the C entry point of each route, on a cache in q's dtype and on the
#: int8 cache; route "fma"'s also takes q's type
_SYMBOLS = {"mma": "decode_attention_mma", "fma": "decode_attention_fwd"}
_QUANT_SYMBOLS = {"gemv": "decode_attention_int8_gemv",
                  "mma": "decode_attention_int8_mma",
                  "fma": "decode_attention_int8_fwd"}


def _attend(symbol: str, route: str, q: torch.Tensor, cache: tuple,
            kv_len: torch.Tensor, hkv: int, t: int, scale: float | None,
            lib: ctypes.CDLL | None = None
            ) -> tuple[torch.Tensor, torch.Tensor, int | None]:
    """(out, lse, the launcher's error code) of one launch of the C entry
    point ``symbol`` (the package's library's, or ``lib``'s: a probe's
    build of a variant) by route ``route``'s split plan on ``cache`` (its
    tensors, in the entry point's order), into new tensors, with the
    splits' scratch; an empty q or cache gives zeros and lse -1e30 and
    launches nothing (error code None)."""
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
    typed = [_TYPE_CODES[q.dtype]] if route == "fma" else []
    argtypes += [ctypes.c_int] * len(typed) + [ctypes.c_void_p]
    if lib is None:
        fn = _build.bind(symbol, argtypes)
    else:
        fn = getattr(lib, symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    with torch.cuda.device(q.device):
        err = fn(*args, *sizes, float(scale), *typed, stream)
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
    out, lse, err = _attend(_SYMBOLS[route], route, q, (k, v), kv_len, hkv,
                            t, scale)
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
    counted.  ``route`` None takes ``decode_quant_route``'s choice of
    ``"gemv"``, ``"mma"`` and ``"fma"``; ``"mma"`` forces the tensor cores
    on inputs ``"gemv"`` takes (every one of them, to time the two on the
    same inputs), ``"fma"`` the first kernel on any.  A failed launch
    raises; no route is tried after another fails."""
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
    chosen = decode_quant_route(q, k_q, v_q)
    if route == "mma" and chosen == "gemv":
        chosen = "mma"  # route "mma" takes whatever "gemv" takes
    route = resolve_route(route, chosen, QUANT_ROUTES,
                          "decode attention on the int8 cache")
    out, lse, err = _attend(_QUANT_SYMBOLS[route], route, q,
                            (k_q, k_s, v_q, v_s), kv_len, hkv, t, scale)
    if err is None:
        return out, lse
    decode_attention_quant_cuda.launches += 1
    decode_attention_quant_cuda.routes[route] += 1
    _build.check(err, f"decode attention on the int8 cache ({route})")
    return out, lse


#: launches of the int8 cache's CUDA kernels in this process, and by route
decode_attention_quant_cuda.launches = 0
decode_attention_quant_cuda.routes = dict.fromkeys(QUANT_ROUTES, 0)

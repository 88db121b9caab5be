"""Launches the MD5 key-search CUDA kernel (``csrc/md5.cu``)."""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..common import stride_grid


def target_words(target) -> tuple[int, int, int, int]:
    """The digest (a, b, c, d) as four ints in [0, 2**32)."""
    words = tuple(int(t) for t in target)
    if len(words) != 4 or not all(0 <= w <= 0xFFFFFFFF for w in words):
        raise ValueError(f"target must be four uint32 words, got {target!r}")
    return words


def md5_search_cuda(
    n: int,
    target: tuple[int, int, int, int],
    device: torch.device | str,
) -> torch.Tensor:
    """(1,) int32 on ``device``: the smallest key in [0, n) whose digest is
    ``target``, or n."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"md5 search: expected a CUDA device, got {device}")
    if not 1 <= n < 2**31:
        raise ValueError(f"n = {n}: the key index is int32, so 1 <= n < 2**31")
    words = target_words(target)
    found = torch.full((1,), n, dtype=torch.int32, device=device)
    grid = stride_grid(n, found.device)
    fn = _build.bind("md5_search_u32", [
        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_uint32, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
    ])
    with torch.cuda.device(found.device):
        err = fn(n, *words, found.data_ptr(), grid,
                 torch.cuda.current_stream().cuda_stream)
    md5_search_cuda.launches += 1
    _build.check(err, "md5_search_u32")
    return found


#: launches of the CUDA kernel in this process
md5_search_cuda.launches = 0

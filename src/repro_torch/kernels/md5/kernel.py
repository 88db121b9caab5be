"""Launches the MD5 key-search CUDA kernels (``csrc/md5.cu``) by one of two
routes: ``"unwind"``, which undoes the target's last eight rounds on the
host and hashes each key through round 52 before it tests it, and
``"fma"``, the first kernel, all 64 rounds of every key."""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..common import resolve_route, stride_grid
from .ref import md5_unwind, md5_word1_target

#: the routes: the target unwound to round 56, and the first kernel
ROUTES = ("unwind", "fma")


def target_words(target) -> tuple[int, int, int, int]:
    """The digest (a, b, c, d) as four ints in [0, 2**32)."""
    words = tuple(int(t) for t in target)
    if len(words) != 4 or not all(0 <= w <= 0xFFFFFFFF for w in words):
        raise ValueError(f"target must be four uint32 words, got {target!r}")
    return words


def md5_route(n: int) -> str:
    """The route a search takes: ``"unwind"`` for every n it can search
    (the unwinding is eight rounds on the host, once a call); ``"fma"``,
    the first kernel, only where named."""
    del n
    return "unwind"


def _found(n: int, device: torch.device | str) -> torch.Tensor:
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"md5 search: expected a CUDA device, got {device}")
    if not 1 <= n < 2**31:
        raise ValueError(f"n = {n}: the key index is int32, so 1 <= n < 2**31")
    return torch.full((1,), n, dtype=torch.int32, device=device)


def md5_search_cuda(
    n: int,
    target: tuple[int, int, int, int],
    device: torch.device | str,
    *,
    route: str | None = None,
) -> torch.Tensor:
    """(1,) int32 on ``device``: the smallest key in [0, n) whose digest is
    ``target``, or n.  ``route`` None takes ``md5_route``'s choice;
    ``"fma"`` forces the first kernel (to time the two on the same
    search)."""
    words = target_words(target)
    route = resolve_route(route, md5_route(n), ROUTES, "md5")
    if route == "unwind":
        state = md5_unwind(words)
        return md5_unwound_search_cuda(n, state, md5_word1_target(state),
                                       device)
    found = _found(n, device)
    fn = _build.bind("md5_search_u32", [
        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_uint32, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
    ])
    with torch.cuda.device(found.device):
        err = fn(n, *words, found.data_ptr(), stride_grid(n, found.device),
                 torch.cuda.current_stream().cuda_stream)
    md5_search_cuda.launches += 1
    md5_search_cuda.routes["fma"] += 1
    _build.check(err, "md5_search_u32")
    return found


def md5_unwound_search_cuda(
    n: int,
    state: tuple[int, int, int, int],
    word1_target: int,
    device: torch.device | str,
) -> torch.Tensor:
    """Route ``"unwind"``'s launch: (1,) int32, the smallest key in [0, n)
    whose state after round 56 is ``state`` and whose b after round 52 plus
    its second word is ``word1_target``, or n.  ``md5_search_cuda`` hands
    it the values ``md5_unwind`` and ``md5_word1_target`` give."""
    words = target_words(state)
    found = _found(n, device)
    fn = _build.bind("md5_unwind_u32", [ctypes.c_uint32] * 6 + [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(found.device):
        err = fn(n, *words, word1_target & 0xFFFFFFFF, found.data_ptr(),
                 stride_grid(n, found.device),
                 torch.cuda.current_stream().cuda_stream)
    md5_search_cuda.launches += 1
    md5_search_cuda.routes["unwind"] += 1
    _build.check(err, "md5_unwind_u32")
    return found


#: launches of the CUDA kernels in this process, and by route
md5_search_cuda.launches = 0
md5_search_cuda.routes = dict.fromkeys(ROUTES, 0)

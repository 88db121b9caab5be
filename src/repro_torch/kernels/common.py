"""Shared helpers for the hand-written Hopper kernels.

Every kernel in this package is CUDA C++ under ``repro_torch/csrc``, built
for ``sm_90a`` by :mod:`repro_torch.kernels._build` and called through a
plain C interface.  Each ``ops.py`` wrapper launches its kernel for a CUDA
tensor and takes the plain PyTorch version in ``ref.py`` only for a tensor
that lies on the CPU.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m


def pad_to(x: torch.Tensor, axis: int, multiple: int, value=0) -> torch.Tensor:
    """Pad ``axis`` up to a multiple of ``multiple`` with ``value``."""
    size = x.shape[axis]
    target = round_up(size, multiple)
    if target == size:
        return x
    # F.pad lists (before, after) pairs from the last axis backwards.
    pads = [0, 0] * x.ndim
    pads[2 * (x.ndim - 1 - axis % x.ndim) + 1] = target - size
    return F.pad(x, pads, value=value)


#: Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
#: at the full 700 W power limit), used only for roofline bounds.
H100_SXM_HBM_BYTES_PER_S = 3.35e12
H100_SXM_FP32_FLOPS = 67e12  # CUDA cores, outside the tensor cores
H100_SXM_BF16_FLOPS = 989e12  # tensor cores
#: 32-bit integer instructions a second: the issue ceiling, one warp
#: instruction per clock on each of an SM's 4 schedulers, 132 SMs x 128
#: lanes x 1.98 GHz boost clock ~= 33.5e12 (derived, not a published peak).
#: No mix issues faster than this.  A 3-input op (LOP3, IADD3) is one.
H100_SXM_INT32_OPS = 132 * 128 * 1.98e9
#: The ALU pipe's share of it: 16 lanes a scheduler, 64 an SM, 16.7e12 a
#: second.  LOP3, IADD3, LEA, SHF and ISETP issue only there; IMAD issues
#: on the FMA pipe, at the same 64 lanes an SM.  The compiler does not spread a mix of adds over both:
#: MD5's first kernel is 201 ALU opcodes to 5 IMAD in its SASS and runs at
#: this rate (13.0-13.1 ms on an H100 80GB HBM3 at 700 W, 12.97 for its
#: 202 instructions a key), and
#: writing half of each round's adds as IMAD raised the rate of the two
#: pipes together to about 92 lanes a clock, not 128
#: (``tools/cuda_core_probe.py --kernels md5``).
H100_SXM_INT32_ALU_OPS = 132 * 64 * 1.98e9
#: Shared memory one block can use on an H100 (opt-in above 48 KiB).
H100_MAX_SHARED_BYTES = 232_448


@functools.cache
def sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


#: threads per block of the grid-stride kernels (their ``kThreads``)
STRIDE_THREADS = 256
#: blocks per SM of a grid-stride kernel's fixed grid
STRIDE_BLOCKS_PER_SM = 8


def stride_grid(items: int, device: torch.device) -> int:
    """Blocks of a grid-stride kernel that walks ``items`` (one per thread
    at a time): enough for every item, at most ``STRIDE_BLOCKS_PER_SM`` on
    each SM of ``device``."""
    return max(1, min(cdiv(items, STRIDE_THREADS),
                      STRIDE_BLOCKS_PER_SM * sm_count(device.index)))


def resolve_route(route: str | None, chosen: str, routes: tuple,
                  what: str) -> str:
    """The route a launch takes: ``chosen`` (the kernel's route function's
    pick) unless the caller names one of the wrapper's ``routes``.  The
    last of them, the first kernel (``"fma"``), may always be named (to time
    it on the same inputs); any other only where it was chosen."""
    if route is None:
        return chosen
    if route not in routes or (route != routes[-1] and route != chosen):
        raise ValueError(f"{what}: route {route!r} does not take these "
                         f"inputs (the route function gives {chosen!r})")
    return route


def check_cuda_tensor(name: str, t: torch.Tensor, dtypes, ndim: int,
                      device: torch.device | None = None) -> None:
    """Raise on what a kernel does not take: the kernels read dense
    row-major buffers of fixed types on one CUDA device."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(
            f"{name}: on {t.device}, but the first argument is on {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {tuple(dtypes)}")
    if t.ndim != ndim:
        raise ValueError(f"{name}: expected {ndim} dimensions, got {t.ndim}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous (call .contiguous())")

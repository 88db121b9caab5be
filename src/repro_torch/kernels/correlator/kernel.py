"""Launches the correlator CUDA kernel (``csrc/correlator.cu``)."""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..common import check_cuda_tensor


#: the kernel's entry point for each sample type
ENTRY = {torch.float32: "correlate_f32", torch.bfloat16: "correlate_bf16"}


def correlate_cuda(samples: torch.Tensor) -> torch.Tensor:
    """samples (C, T, A, 2) f32 or bf16, CUDA, contiguous → visibilities
    (C, A, A, 2) in the samples' type (summed in f32) in a new tensor.
    Ragged T and A are masked inside the kernel."""
    check_cuda_tensor("samples", samples, tuple(ENTRY), 4)
    c, t, a, two = samples.shape
    if two != 2:
        raise ValueError(f"samples must be (C, T, A, 2) re/im pairs, got "
                         f"{tuple(samples.shape)}")
    if c > 65535:
        raise ValueError(f"{c} channels: the kernel's grid takes at most "
                         "65535")
    if max(c * t * a, c * a * a) >= 2**62 or t >= 2**31 or a >= 2**31:
        raise ValueError(f"too large: C={c}, T={t}, A={a}")
    pair = 2 * samples.element_size()
    if samples.data_ptr() % pair:
        raise ValueError(f"samples must be {pair}-byte aligned (re/im pairs "
                         "are read as one word)")
    out = torch.empty((c, a, a, 2), dtype=samples.dtype,
                      device=samples.device)
    if out.numel() == 0:
        return out
    entry = ENTRY[samples.dtype]
    fn = _build.bind(entry, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ])
    with torch.cuda.device(samples.device):
        err = fn(samples.data_ptr(), out.data_ptr(), c, t, a,
                 torch.cuda.current_stream().cuda_stream)
    correlate_cuda.launches += 1
    _build.check(err, entry)
    return out


#: launches of the CUDA kernel in this process
correlate_cuda.launches = 0

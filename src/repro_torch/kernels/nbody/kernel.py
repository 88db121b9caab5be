"""Launches the N-Body CUDA kernel (``csrc/nbody.cu``)."""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..common import check_cuda_tensor
from .ref import SOFTENING2


def nbody_cuda(
    posm: torch.Tensor,  # (n, 4) f32 xyz + mass, CUDA
    *,
    softening2: float = SOFTENING2,
) -> torch.Tensor:
    """Accelerations (n, 3) f32 into a new tensor."""
    check_cuda_tensor("posm", posm, (torch.float32,), 2)
    n, four = posm.shape
    if four != 4:
        raise ValueError(f"posm must be (n, 4) xyz + mass, got "
                         f"{tuple(posm.shape)}")
    if n >= 2**31:
        raise ValueError(f"{n} bodies: the body index is int32")
    if posm.data_ptr() % 16:
        raise ValueError("posm must be 16-byte aligned (rows are float4)")
    acc = torch.empty((n, 3), dtype=torch.float32, device=posm.device)
    if n == 0:
        return acc
    fn = _build.bind("nbody_forces_f32", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
        ctypes.c_void_p,
    ])
    with torch.cuda.device(posm.device):
        err = fn(posm.data_ptr(), acc.data_ptr(), n, softening2,
                 torch.cuda.current_stream().cuda_stream)
    nbody_cuda.launches += 1
    _build.check(err, "nbody_forces_f32")
    return acc


#: launches of the CUDA kernel in this process
nbody_cuda.launches = 0

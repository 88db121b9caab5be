"""Launches the HotSpot CUDA kernel (``csrc/hotspot.cu``)."""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..common import check_cuda_tensor
from .ref import DEFAULTS


def hotspot_cuda(
    temp: torch.Tensor,  # (rows, cols) f32, CUDA
    power: torch.Tensor,  # (rows, cols) f32, CUDA
    *,
    sdc: float = DEFAULTS["sdc"],
    rx: float = DEFAULTS["rx"],
    ry: float = DEFAULTS["ry"],
    rz: float = DEFAULTS["rz"],
    amb: float = DEFAULTS["amb"],
) -> torch.Tensor:
    """One HotSpot step into a new tensor; the inputs are not written."""
    check_cuda_tensor("temp", temp, (torch.float32,), 2)
    check_cuda_tensor("power", power, (torch.float32,), 2, device=temp.device)
    if temp.shape != power.shape:
        raise ValueError(f"shapes disagree: temp {tuple(temp.shape)}, "
                         f"power {tuple(power.shape)}")
    rows, cols = temp.shape
    out = torch.empty_like(temp)
    if rows == 0 or cols == 0:
        return out
    fn = _build.bind("hotspot_step_f32", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
    ])
    with torch.cuda.device(temp.device):
        err = fn(temp.data_ptr(), power.data_ptr(), out.data_ptr(), rows,
                 cols, sdc, rx, ry, rz, amb,
                 torch.cuda.current_stream().cuda_stream)
    hotspot_cuda.launches += 1
    _build.check(err, "hotspot_step_f32")
    return out


#: launches of the CUDA kernel in this process
hotspot_cuda.launches = 0

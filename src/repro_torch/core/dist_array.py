"""Distributed multi-dimensional arrays (paper §2.2) on ``torch.Tensor``.

A :class:`DistributedArray` pairs a tensor on one device with a chunk
:class:`~repro_torch.core.distributions.Distribution`.  On a single device
it is an ordinary tensor, and the chunk structure exists only in planner
metadata (exactly the paper's "distributions affect performance, not
correctness").  Placement over several workers arrives with multi-worker
execution.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .distributions import Distribution
from .ndrange import Region
from .planner import ArrayMeta


# eq=False: comparing two arrays field by field would compare tensors
# elementwise and has no truth value.
@dataclasses.dataclass(eq=False)
class DistributedArray:
    """A logically-global array with a chunk distribution."""

    name: str
    value: torch.Tensor
    dist: Distribution

    # -- metadata ---------------------------------------------------------------

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.value.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.value.dtype

    @property
    def device(self) -> torch.device:
        return self.value.device

    @property
    def nbytes(self) -> int:
        return math.prod(self.shape) * self.value.element_size()

    def meta(self) -> ArrayMeta:
        return ArrayMeta(
            name=self.name,
            shape=self.shape,
            dtype_size=self.value.element_size(),
            dist=self.dist,
        )

    def chunks(self, num_devices: int | None = None):
        return self.dist.chunks(self.shape, num_devices or 1)

    # -- data access --------------------------------------------------------------

    def to_numpy(self) -> np.ndarray:
        return self.value.detach().cpu().numpy()

    def read_region(self, region: Region) -> np.ndarray:
        return self.to_numpy()[region.to_slices()]

    def replace_value(self, value: torch.Tensor) -> "DistributedArray":
        return dataclasses.replace(self, value=value)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"DistributedArray({self.name!r}, shape={self.shape}, "
            f"dtype={self.dtype}, device={self.device}, "
            f"dist={type(self.dist).__name__})"
        )


def make_array(
    name: str,
    value: torch.Tensor | np.ndarray,
    dist: Distribution,
    device: torch.device | str = "cuda",
) -> DistributedArray:
    """Place ``value`` on ``device`` and attach ``dist`` to it.  A numpy
    array is copied, never aliased: launches are functional updates, and the
    caller's buffer stays the caller's."""
    if isinstance(value, np.ndarray):
        if torch.device(device).type == "cpu" or not value.flags.writeable:
            value = np.array(value)
        value = torch.from_numpy(value)
    return DistributedArray(name=name, value=value.to(device).contiguous(),
                            dist=dist)

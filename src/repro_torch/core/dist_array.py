"""Distributed multi-dimensional arrays (paper §2.2) on ``torch.Tensor``.

A :class:`DistributedArray` pairs a tensor with a chunk
:class:`~repro_torch.core.distributions.Distribution`.  ``value`` is always
the logical global tensor, on the context's device.  Without a mesh the
chunk structure exists only in planner metadata (exactly the paper's
"distributions affect performance, not correctness"); on a
:class:`~repro_torch.core.mesh.Mesh` the distribution's partition spec says
which piece of it each worker holds (:meth:`DistributedArray.shards`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device

from .distributions import Distribution, ReplicatedDist
from .mesh import Mesh, check_divisible, shard_of
from .ndrange import Region
from .planner import ArrayMeta


class Sharding(NamedTuple):
    """The placement of an array on a mesh: the reference's
    ``NamedSharding(mesh, spec)``."""

    mesh: Mesh
    spec: tuple


# eq=False: comparing two arrays field by field would compare tensors
# elementwise and has no truth value.
@dataclasses.dataclass(eq=False)
class DistributedArray:
    """A logically-global array with a chunk distribution."""

    name: str
    value: torch.Tensor
    dist: Distribution
    mesh: Mesh | None = None
    mesh_axes: tuple[str, ...] = ()

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

    def partition_spec(self) -> tuple:
        """The distribution's spec over ``mesh_axes``, padded with None (or
        cut) to the array's rank; () without a mesh or for a replicated
        array.  An entry naming one axis is that name, and one naming none
        is None, as the reference's ``PartitionSpec`` has them."""
        if self.mesh is None or isinstance(self.dist, ReplicatedDist):
            return ()
        spec = tuple(
            (e[0] if len(e) == 1 else e or None) if isinstance(e, tuple)
            else e for e in self.dist.partition_spec(self.mesh_axes))
        spec = spec + (None,) * (len(self.shape) - len(spec))
        return spec[: len(self.shape)]

    def sharding(self) -> Sharding | None:
        if self.mesh is None:
            return None
        return Sharding(self.mesh, self.partition_spec())

    def chunks(self, num_devices: int | None = None):
        nd = num_devices or (self.mesh.size if self.mesh is not None else 1)
        return self.dist.chunks(self.shape, nd)

    def shards(self) -> list[torch.Tensor]:
        """Each worker's piece of ``value`` by the partition spec, by flat
        worker index: views where the worker lies on ``value``'s device,
        copies otherwise.  Without a mesh, ``[value]``."""
        if self.mesh is None:
            return [self.value]
        spec = self.partition_spec()
        return [shard_of(self.value, spec, self.mesh, w)
                for w in range(self.mesh.size)]

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
    mesh: Mesh | None = None,
    mesh_axes: Sequence[str] = (),
    *,
    device: torch.device | str | None = None,
) -> DistributedArray:
    """Place ``value`` on ``device`` and attach ``dist`` to it (and the
    mesh, whose workers take their pieces of it at each launch).  The
    reference's parameters keep its order; ``device`` (keyword-only) None
    means the mesh's first worker's device, or the GPU without a mesh.  A
    numpy array is copied, never aliased: launches are functional updates,
    and the caller's buffer stays the caller's.  On a mesh of more than one
    worker, a sharded axis that does not split evenly raises, as the
    reference's placement does."""
    if device is None:
        device = (mesh.devices.flat[0] if mesh is not None
                  else resolve_device(None))
    if isinstance(value, np.ndarray):
        if torch.device(device).type == "cpu" or not value.flags.writeable:
            value = np.array(value)
        value = torch.from_numpy(value)
    arr = DistributedArray(name=name, value=value.to(device).contiguous(),
                           dist=dist, mesh=mesh, mesh_axes=tuple(mesh_axes))
    if mesh is not None and mesh.size > 1:
        check_divisible(arr.shape, arr.partition_spec(), mesh,
                        f"array {name!r}")
    return arr

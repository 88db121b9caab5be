"""Distributed multi-dimensional arrays (paper §2.2) on ``torch.Tensor``.

A :class:`DistributedArray` pairs a tensor with a chunk
:class:`~repro_torch.core.distributions.Distribution`.  Without a mesh, or
on a :class:`~repro_torch.core.mesh.Mesh` of workers on one controller,
``value`` is the logical global tensor, on the context's device.  Without a
mesh the chunk structure exists only in planner metadata (exactly the
paper's "distributions affect performance, not correctness"); on a
:class:`~repro_torch.core.mesh.Mesh` the distribution's partition spec says
which piece of it each worker holds (:meth:`DistributedArray.shards`).

On a rank mesh (a ``DeviceMesh`` of ``torch.distributed`` ranks) ``value``
is this rank's shard alone, on the rank's device, as the reference's
``device_put`` onto a ``NamedSharding`` leaves each device its shard:
``shape``, ``nbytes`` and ``meta()`` stay global (the planner plans on
global shapes), and ``to_numpy()`` and ``read_region()`` are collective,
the whole array on every rank.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.dist import ranks

from .distributions import Distribution, ReplicatedDist
from .mesh import (
    Mesh,
    check_divisible,
    is_rank_mesh,
    local_worker,
    mesh_size,
    shard_of,
    shard_shape,
)
from .ndrange import Region
from .planner import ArrayMeta


class Sharding(NamedTuple):
    """The placement of an array on a mesh: the reference's
    ``NamedSharding(mesh, spec)``."""

    mesh: Mesh
    spec: tuple


def placement_spec(dist: Distribution, mesh, mesh_axes: Sequence[str],
                   ndim: int) -> tuple:
    """``dist``'s spec over ``mesh_axes``, padded with None (or cut) to
    ``ndim``; () without a mesh or for a replicated distribution.  An
    entry naming one axis is that name, and one naming none is None, as
    the reference's ``PartitionSpec`` has them."""
    if mesh is None or isinstance(dist, ReplicatedDist):
        return ()
    spec = tuple(
        (e[0] if len(e) == 1 else e or None) if isinstance(e, tuple)
        else e for e in dist.partition_spec(tuple(mesh_axes)))
    spec = spec + (None,) * (ndim - len(spec))
    return spec[:ndim]


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
    #: the global shape where ``value`` is a rank's shard (a rank mesh);
    #: None where ``value`` is the whole array
    global_shape: tuple[int, ...] | None = None

    # -- metadata ---------------------------------------------------------------

    @property
    def shape(self) -> tuple[int, ...]:
        if self.global_shape is not None:
            return self.global_shape
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
        array (:func:`placement_spec`)."""
        return placement_spec(self.dist, self.mesh, self.mesh_axes,
                              len(self.shape))

    def sharding(self) -> Sharding | None:
        if self.mesh is None:
            return None
        return Sharding(self.mesh, self.partition_spec())

    def chunks(self, num_devices: int | None = None):
        nd = num_devices or (mesh_size(self.mesh) if self.mesh is not None
                             else 1)
        return self.dist.chunks(self.shape, nd)

    def shards(self) -> list[torch.Tensor]:
        """Each worker's piece of ``value`` by the partition spec, by flat
        worker index: views where the worker lies on ``value``'s device,
        copies otherwise.  Without a mesh, ``[value]``; on a rank mesh,
        ``[value]`` too: a rank holds its own shard only."""
        if self.mesh is None or is_rank_mesh(self.mesh):
            return [self.value]
        spec = self.partition_spec()
        return [shard_of(self.value, spec, self.mesh, w)
                for w in range(self.mesh.size)]

    # -- data access --------------------------------------------------------------

    def to_numpy(self) -> np.ndarray:
        """The whole array on the host.  On a rank mesh every rank's shard
        is gathered: a collective, which every rank of the mesh calls."""
        value = self.value
        if is_rank_mesh(self.mesh):
            with ranks.use_mesh(self.mesh):
                value = ranks.spec_gather(value, self.partition_spec())
        return value.detach().cpu().numpy()

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
    reference's placement does.

    On a rank mesh ``value`` is the whole array, which every rank passes:
    a rank takes its own slice of it first (of the host array, where it is
    one) and moves only that slice to ``device``, which is then required.
    The uneven split raises on every rank alike, before any collective."""
    rank = is_rank_mesh(mesh)
    if rank:
        if device is None:
            raise ValueError("an array on a rank mesh needs the rank's "
                             "device")
        shape = tuple(value.shape)
        spec = placement_spec(dist, mesh, mesh_axes, len(shape))
        check_divisible(shape, spec, mesh, f"array {name!r}")
        value = shard_of(value, spec, mesh, local_worker(mesh))
    elif device is None:
        device = (mesh.devices.flat[0] if mesh is not None
                  else resolve_device(None))
    if isinstance(value, np.ndarray):
        if torch.device(device).type == "cpu" or not value.flags.writeable \
                or not value.flags.c_contiguous:
            value = np.array(value)
        value = torch.from_numpy(value)
    arr = DistributedArray(name=name, value=value.to(device).contiguous(),
                           dist=dist, mesh=mesh, mesh_axes=tuple(mesh_axes),
                           global_shape=shape if rank else None)
    if not rank and mesh is not None and mesh.size > 1:
        check_divisible(arr.shape, arr.partition_spec(), mesh,
                        f"array {name!r}")
    return arr


def full_array(
    name: str,
    shape: Sequence[int],
    fill,
    dtype: torch.dtype,
    dist: Distribution,
    mesh=None,
    mesh_axes: Sequence[str] = (),
    *,
    device: torch.device | str | None = None,
) -> DistributedArray:
    """An array of ``shape`` filled with ``fill``, placed as
    :func:`make_array` places one; on a rank mesh only this rank's shard
    is allocated."""
    shape = tuple(int(s) for s in shape)
    if not is_rank_mesh(mesh):
        return make_array(name, torch.full(shape, fill, dtype=dtype,
                                           device=device),
                          dist, mesh, mesh_axes, device=device)
    spec = placement_spec(dist, mesh, mesh_axes, len(shape))
    check_divisible(shape, spec, mesh, f"array {name!r}")
    value = torch.full(shard_shape(shape, spec, mesh), fill, dtype=dtype,
                       device=device)
    return DistributedArray(name=name, value=value, dist=dist, mesh=mesh,
                            mesh_axes=tuple(mesh_axes), global_shape=shape)

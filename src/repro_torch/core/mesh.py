"""Worker meshes: the port's counterpart of what the reference takes from
``jax.sharding``.

A :class:`Mesh` is an array of workers with named axes, as ``jax.sharding.Mesh``
is an array of devices.  A worker is a slot that holds its own shard of each
distributed array and runs its own call of a kernel body; it lies on a
``torch.device``, and several workers may lie on one device (on one GPU,
the workers of a launch run one after another on its current stream).
Partition specs stay plain tuples of axis names or ``None``, one entry per
array axis, as :meth:`Distribution.partition_spec` returns them; an entry
may also be a tuple of axis names, sharding that array axis over their
product.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device


class Mesh:
    """Workers in an array of ``len(axis_names)`` dimensions.  Worker ``w``
    is element ``w`` of ``devices`` in row-major order: its flat index, the
    reference's ``idx * mesh.shape[ax] + axis_index(ax)`` over the axes."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if arr.ndim != len(self.axis_names):
            raise ValueError(f"devices of shape {arr.shape} for axes "
                             f"{self.axis_names}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated mesh axis in {self.axis_names}")
        self.devices = np.empty(arr.shape, dtype=object)
        for idx, dev in np.ndenumerate(arr):
            self.devices[idx] = torch.device(dev)
        if any(d.type == "cuda" for d in self.devices.flat) \
                and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device found for a mesh of CUDA "
                               "workers")

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, in axis order (``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def worker_devices(self) -> list[torch.device]:
        """Each worker's device, by flat index."""
        return list(self.devices.flat)

    def coords(self, worker: int) -> dict[str, int]:
        """Axis name -> the worker's index along it."""
        return dict(zip(self.axis_names, map(int, np.unravel_index(
            worker, self.devices.shape))))

    def worker_at(self, coords: dict[str, int]) -> int:
        return int(np.ravel_multi_index(
            [coords[ax] for ax in self.axis_names], self.devices.shape))

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        devices = sorted(set(map(str, self.devices.flat)))
        return f"Mesh({self.shape}, devices={devices})"


def make_mesh(
    shape: Sequence[int],
    axis_names: Sequence[str],
    device: torch.device | str | Sequence | None = None,
) -> Mesh:
    """A mesh of ``prod(shape)`` workers.  ``device`` None means the GPU
    (and fails where there is none); every worker lies on that one device,
    unless ``device`` is a list of ``prod(shape)`` devices, one a worker."""
    shape = tuple(int(s) for s in shape)
    if isinstance(device, (list, tuple)):
        if len(device) != math.prod(shape):
            raise ValueError(f"{len(device)} devices for a mesh of "
                             f"{math.prod(shape)} workers")
        devices = [torch.device(d) for d in device]
    else:
        devices = [resolve_device(device)] * math.prod(shape)
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(shape), axis_names)


def spec_axes(entry) -> tuple[str, ...]:
    """One entry of a partition spec as a tuple of axis names (() for
    None)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_index(mesh: Mesh, worker: int, axes: tuple[str, ...]):
    """(index, count): which of the ``count`` pieces along an array axis
    sharded over ``axes`` the worker holds."""
    coords = mesh.coords(worker)
    index, count = 0, 1
    for ax in axes:
        index = index * mesh.shape[ax] + coords[ax]
        count *= mesh.shape[ax]
    return index, count


def check_divisible(shape: Sequence[int], spec: tuple, mesh: Mesh,
                    what: str) -> None:
    """Raise where a sharded axis does not split evenly, as the reference's
    placement on a ``NamedSharding`` does."""
    for dim, entry in enumerate(spec):
        count = math.prod(mesh.shape[ax] for ax in spec_axes(entry))
        if shape[dim] % count:
            raise ValueError(
                f"{what}: axis {dim} of size {shape[dim]} does not split "
                f"over {count} workers of mesh axes {spec_axes(entry)}")


def shard_of(value: torch.Tensor, spec: tuple, mesh: Mesh,
             worker: int) -> torch.Tensor:
    """The worker's piece of ``value`` by ``spec``: a view where the worker
    lies on ``value``'s device, a copy on the worker's device otherwise."""
    check_divisible(value.shape, spec, mesh, "shard")
    piece = value
    for dim, entry in enumerate(spec):
        axes = spec_axes(entry)
        if axes:
            index, count = shard_index(mesh, worker, axes)
            size = value.shape[dim] // count
            piece = piece.narrow(dim, index * size, size)
    return piece.to(mesh.devices.flat[worker])


def assemble(pieces: Sequence[torch.Tensor], spec: tuple, mesh: Mesh,
             device: torch.device) -> torch.Tensor:
    """The global tensor from the workers' pieces by ``spec`` (the inverse
    of :func:`shard_of`), on ``device``.  Workers that hold the same piece
    (the mesh axes the spec leaves out) are replicas: the first is taken."""
    dims = [(d, spec_axes(e)) for d, e in enumerate(spec) if spec_axes(e)]
    if not dims:
        return pieces[0].to(device)
    grid: dict[tuple, torch.Tensor] = {}
    for worker, piece in enumerate(pieces):
        key = tuple(shard_index(mesh, worker, axes)[0] for _, axes in dims)
        grid.setdefault(key, piece)

    def build(prefix: tuple) -> torch.Tensor:
        if len(prefix) == len(dims):
            return grid[prefix].to(device)
        dim, axes = dims[len(prefix)]
        count = shard_index(mesh, 0, axes)[1]
        return torch.cat([build(prefix + (i,)) for i in range(count)],
                         dim=dim)

    return build(())

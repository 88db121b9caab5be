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

A *rank mesh* is the other kind a launch takes: the ``DeviceMesh`` of
``repro_torch.launch.mesh.make_mesh`` over the ranks of a
``torch.distributed`` group, one process a worker, each holding only its
own shards (the reference's mesh under JAX's multi-controller model).
:func:`mesh_shape`, :func:`mesh_size` and :func:`mesh_coords` read both
kinds alike, and :func:`shard_index`, :func:`check_divisible` and
:func:`shard_of` take either; :func:`local_worker` is a rank's own flat
index.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.dist import ranks


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


def is_rank_mesh(mesh) -> bool:
    """Whether ``mesh`` is a mesh of ranks (a ``DeviceMesh``), not of
    workers on one controller."""
    return mesh is not None and not isinstance(mesh, Mesh)


def mesh_shape(mesh) -> dict[str, int]:
    """Axis name -> size, in axis order, of a :class:`Mesh` or a rank
    mesh."""
    if isinstance(mesh, Mesh):
        return mesh.shape
    return ranks.mesh_sizes(mesh)


def mesh_size(mesh) -> int:
    return math.prod(mesh_shape(mesh).values())


def mesh_coords(mesh, worker: int) -> dict[str, int]:
    """Axis name -> worker ``worker``'s index along it (its flat index
    unravelled row-major over the axes, for either kind of mesh)."""
    shape = mesh_shape(mesh)
    return dict(zip(shape, map(int, np.unravel_index(
        worker, tuple(shape.values())))))


def local_worker(mesh) -> int:
    """This rank's flat index on a rank mesh: ``ranks.axis_index`` over
    all of its axes, row-major."""
    with ranks.use_mesh(mesh):
        return ranks.axis_index(tuple(mesh_shape(mesh)))


def spec_axes(entry) -> tuple[str, ...]:
    """One entry of a partition spec as a tuple of axis names (() for
    None)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_index(mesh, worker: int, axes: tuple[str, ...]):
    """(index, count): which of the ``count`` pieces along an array axis
    sharded over ``axes`` the worker holds."""
    coords, shape = mesh_coords(mesh, worker), mesh_shape(mesh)
    index, count = 0, 1
    for ax in axes:
        index = index * shape[ax] + coords[ax]
        count *= shape[ax]
    return index, count


def check_divisible(shape: Sequence[int], spec: tuple, mesh,
                    what: str) -> None:
    """Raise where a sharded axis does not split evenly, as the reference's
    placement on a ``NamedSharding`` does."""
    sizes = mesh_shape(mesh)
    for dim, entry in enumerate(spec):
        count = math.prod(sizes[ax] for ax in spec_axes(entry))
        if shape[dim] % count:
            raise ValueError(
                f"{what}: axis {dim} of size {shape[dim]} does not split "
                f"over {count} workers of mesh axes {spec_axes(entry)}")


def shard_shape(shape: Sequence[int], spec: tuple, mesh) -> tuple:
    """The shape of one worker's piece of an array of ``shape`` by
    ``spec`` (an even split: see :func:`check_divisible`)."""
    sizes = mesh_shape(mesh)
    out = list(shape)
    for dim, entry in enumerate(spec):
        out[dim] //= math.prod(sizes[ax] for ax in spec_axes(entry))
    return tuple(out)


def shard_of(value, spec: tuple, mesh, worker: int):
    """The worker's piece of ``value`` by ``spec``: on a :class:`Mesh`, a
    view where the worker lies on ``value``'s device, a copy on the
    worker's device otherwise; on a rank mesh, a view of ``value`` (a
    tensor or a numpy array, which a rank slices before it moves anything
    to its device)."""
    check_divisible(value.shape, spec, mesh, "shard")
    piece = value
    for dim, entry in enumerate(spec):
        axes = spec_axes(entry)
        if axes:
            index, count = shard_index(mesh, worker, axes)
            size = value.shape[dim] // count
            cut = [slice(None)] * value.ndim
            cut[dim] = slice(index * size, (index + 1) * size)
            piece = piece[tuple(cut)]
    if is_rank_mesh(mesh):
        return piece
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

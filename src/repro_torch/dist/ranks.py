"""Ranks: the port's counterparts of JAX's named-axis primitives.

The reference runs its collectives inside ``shard_map``, where every device
names the others by mesh axis (``lax.psum(x, "data")``,
``lax.ppermute(x, "data", perm)``, ``lax.axis_index("data")``).  Here a
device is a rank: one process of a ``torch.distributed`` group, and the
named mesh of ranks is PyTorch's ``DeviceMesh``.  This module resolves an
axis name (or a tuple of them) against the current mesh (``use_mesh``,
``set_mesh``; ``repro_torch.launch.mesh.make_mesh`` sets it), and every
collective of the port goes through its functions:

* ``axis_size`` / ``axis_index``: the ranks along the axes, and this rank's
  index among them (row-major over a tuple, as ``lax.axis_index``);
* ``ppermute``: point-to-point sends by a permutation of indices along the
  axes (``batch_isend_irecv`` with the peers' global ranks); an index that
  no pair sends to receives zeros;
* ``psum`` / ``pmax``: all-reduce, one axis after another over a tuple;
* ``all_gather``: the ranks' tensors stacked on a new leading axis, in
  index order;
* ``psum_grad``: ``psum`` with a backward (the psum of the gradient), for a
  batch statistic inside a train step's forward pass.

``recording(sizes, coords)`` makes a :class:`RecordingMesh` current: a mesh
that exists only as ``{axis: size}`` and one rank's coordinates, for the
dry run (``repro_torch.launch.dryrun``).  Under it those primitives take
``meta`` tensors, return ``meta`` results of the shapes the real calls
give, and record each call's operation, axis, operand and output bytes; a
real tensor under it raises, as does a ``meta`` tensor under a real mesh.

Under gloo a CUDA tensor is copied to pinned host memory and back around
each operation (gloo's send and receive take a host pointer).  The copies
are explicit: their bytes are counted by the ``dist.staged_bytes`` counter
of the default metrics registry.  Under NCCL the tensors go as they are.

``spawn`` starts the ranks of one machine: ``torch.multiprocessing`` with a
``file://`` rendezvous in a directory of its own (so that concurrent runs
never race for a port), explicit timeouts on the group and on the join, and
each rank's return value handed back to the caller.
"""

from __future__ import annotations

import contextlib
import math
import os
import pickle
import shutil
import tempfile
import time
from datetime import timedelta
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist

from repro_torch.obs.metrics import default_registry

#: seconds a group waits for a collective, and ``spawn`` for its ranks
TIMEOUT_S = 300.0

_MESH = None


# ---------------------------------------------------------------------------
# The current mesh
# ---------------------------------------------------------------------------


def set_mesh(mesh) -> Any:
    """Make ``mesh`` (a ``DeviceMesh``, or None) the one axis names resolve
    against; returns the previous one."""
    global _MESH
    prev, _MESH = _MESH, mesh
    return prev


def current_mesh():
    if _MESH is None:
        raise RuntimeError("no current mesh of ranks: build one with "
                           "repro_torch.launch.mesh.make_mesh or use_mesh")
    return _MESH


@contextlib.contextmanager
def use_mesh(mesh):
    """``mesh`` is the current mesh inside the block."""
    prev = set_mesh(mesh)
    try:
        yield mesh
    finally:
        set_mesh(prev)


class RecordingMesh:
    """A mesh of ranks as sizes alone: ``sizes`` ({axis: ranks}) and this
    rank's ``coords`` along each axis (0 where not given).  The primitives
    of this module, under it, record in ``records`` one ``(op, axis,
    operand bytes, output bytes)`` for each call the real mesh would make
    (an axis of one rank included): ``psum`` and
    ``pmax`` an ``"all-reduce"`` an axis, ``all_gather`` an
    ``"all-gather"`` an axis, ``ppermute`` a ``"collective-permute"``
    where this rank sends (axis the names joined by ``+``)."""

    device_type = "meta"

    def __init__(self, sizes: dict, coords: dict | None = None):
        self.sizes = {str(a): int(n) for a, n in sizes.items()}
        self.coords = {a: 0 for a in self.sizes}
        self.coords.update(coords or {})
        self.records: list[tuple[str, str, int, int]] = []

    @property
    def mesh_dim_names(self) -> tuple[str, ...]:
        return tuple(self.sizes)

    def get_local_rank(self, axis: str) -> int:
        return int(self.coords[axis])

    def record(self, op: str, axis: str, x: torch.Tensor,
               out: torch.Tensor) -> torch.Tensor:
        """Record one call of ``op`` on ``x`` giving ``out``; returns
        ``out``."""
        self.records.append((op, axis, x.numel() * x.element_size(),
                             out.numel() * out.element_size()))
        return out


@contextlib.contextmanager
def recording(sizes: dict, coords: dict | None = None):
    """A :class:`RecordingMesh` of ``sizes`` is the current mesh inside the
    block; yields it."""
    with use_mesh(RecordingMesh(sizes, coords)) as mesh:
        yield mesh


def _recorder(x: torch.Tensor) -> RecordingMesh | None:
    """The current mesh where it records (``x`` must then be a ``meta``
    tensor), else None (``x`` must then hold data)."""
    if isinstance(_MESH, RecordingMesh):
        if x.device.type != "meta":
            raise RuntimeError(f"a recording mesh takes meta tensors, not "
                               f"one on {x.device}")
        return _MESH
    if x.device.type == "meta":
        raise RuntimeError("a meta tensor in a collective needs a "
                           "recording mesh (ranks.recording)")
    return None


def mesh_sizes(mesh) -> dict[str, int]:
    """Axis name -> ranks along it, in the mesh's axis order."""
    if isinstance(mesh, dict):
        return {str(k): int(v) for k, v in mesh.items()}
    if isinstance(mesh, RecordingMesh):
        return dict(mesh.sizes)
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.mesh.shape)))


def _axes(axis: str | Sequence[str]) -> tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def axis_size(axis: str | Sequence[str]) -> int:
    sizes = mesh_sizes(current_mesh())
    return math.prod(sizes[a] for a in _axes(axis))


def axis_index(axis: str | Sequence[str]) -> int:
    """This rank's index along ``axis``; over a tuple of axes, row-major in
    the tuple's order."""
    mesh = current_mesh()
    sizes = mesh_sizes(mesh)
    index = 0
    for a in _axes(axis):
        index = index * sizes[a] + int(mesh.get_local_rank(a))
    return index


def _global_rank(axes: tuple[str, ...], index: int) -> int:
    """The global rank at ``index`` along ``axes`` that shares this rank's
    coordinates on every other axis."""
    mesh = current_mesh()
    if len(axes) == 1:
        return dist.get_global_rank(mesh.get_group(axes[0]), index)
    sizes = mesh_sizes(mesh)
    coords = {a: int(mesh.get_local_rank(a)) for a in sizes}
    for a in reversed(axes):
        coords[a] = index % sizes[a]
        index //= sizes[a]
    return int(mesh.mesh[tuple(coords[a] for a in sizes)])


# ---------------------------------------------------------------------------
# Staging through the host under gloo
# ---------------------------------------------------------------------------


def _staged(x: torch.Tensor, group=None) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _to_host(x: torch.Tensor) -> torch.Tensor:
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x)
    default_registry().counter("dist.staged_bytes").inc(
        x.numel() * x.element_size())
    return host


def _to_device(host: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    out = host.to(like.device)
    default_registry().counter("dist.staged_bytes").inc(
        host.numel() * host.element_size())
    return out


def staged_bytes() -> float:
    """Bytes copied between a card and the host around gloo operations in
    this process so far."""
    return default_registry().counter("dist.staged_bytes").value()


# ---------------------------------------------------------------------------
# Primitives
# ---------------------------------------------------------------------------


def _all_reduce(x: torch.Tensor, op, axis: str) -> torch.Tensor:
    rec = _recorder(x)
    if rec is not None:
        return rec.record("all-reduce", axis, x, torch.empty_like(
            x, memory_format=torch.contiguous_format))
    group = current_mesh().get_group(axis)
    if _staged(x, group):
        host = _to_host(x.contiguous())
        dist.all_reduce(host, op=op, group=group)
        return _to_device(host, x)
    out = x.contiguous().clone()
    dist.all_reduce(out, op=op, group=group)
    return out


def psum(x: torch.Tensor, axis: str | Sequence[str]) -> torch.Tensor:
    """The sum over the ranks along ``axis`` (a tuple: one axis after
    another), on every one of them."""
    for a in _axes(axis):
        x = _all_reduce(x, dist.ReduceOp.SUM, a)
    return x


def pmax(x: torch.Tensor, axis: str | Sequence[str]) -> torch.Tensor:
    for a in _axes(axis):
        x = _all_reduce(x, dist.ReduceOp.MAX, a)
    return x


def _gather_one(x: torch.Tensor, axis: str) -> torch.Tensor:
    rec = _recorder(x)
    if rec is not None:
        return rec.record("all-gather", axis, x, x.new_empty(
            (rec.sizes[axis],) + tuple(x.shape)))
    group = current_mesh().get_group(axis)
    n = dist.get_world_size(group)
    staged = _staged(x, group)
    src = _to_host(x.contiguous()) if staged else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.stack(parts)
    return _to_device(out, x) if staged else out


def all_gather(x: torch.Tensor, axis: str | Sequence[str]) -> torch.Tensor:
    """Every rank's ``x`` along ``axis``, stacked on a new leading axis in
    index order (``lax.all_gather``)."""
    axes = _axes(axis)
    for a in reversed(axes):
        x = _gather_one(x, a)
    lead = math.prod(x.shape[:len(axes)])
    return x.reshape((lead,) + tuple(x.shape[len(axes):]))


def ppermute(x: torch.Tensor, axis: str | Sequence[str],
             perm: Sequence[tuple[int, int]]) -> torch.Tensor:
    """``x`` sent from index i to index j along ``axis`` for each (i, j) of
    ``perm``; a rank that no pair sends to gets zeros (``lax.ppermute``)."""
    axes = _axes(axis)
    me = axis_index(axes)
    dst = [j for i, j in perm if i == me]
    src = [i for i, j in perm if j == me]
    if len(dst) > 1 or len(src) > 1:
        raise ValueError(f"perm {perm} is not a permutation")
    if dst == [me]:  # to itself: no message
        return x.clone()
    rec = _recorder(x)
    if rec is not None:
        out = torch.empty_like(x, memory_format=torch.contiguous_format)
        return rec.record("collective-permute", "+".join(axes), x, out) \
            if dst else out
    x = x.contiguous()
    staged = _staged(x)
    send = _to_host(x) if staged and dst else x
    recv = torch.zeros_like(send) if src else None
    ops = []
    if dst:
        ops.append(dist.P2POp(dist.isend, send, _global_rank(axes, dst[0])))
    if src:
        ops.append(dist.P2POp(dist.irecv, recv, _global_rank(axes, src[0])))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if recv is None:
        return torch.zeros_like(x)
    return _to_device(recv, x) if staged else recv


class _PsumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes):
        ctx.axes = axes
        return psum(x, axes)

    @staticmethod
    def backward(ctx, g):
        return psum(g.contiguous(), ctx.axes), None


def psum_grad(x: torch.Tensor, axis: str | Sequence[str]) -> torch.Tensor:
    """``psum`` whose backward is the psum of the incoming gradient, as the
    transpose of ``lax.psum`` under ``shard_map``."""
    return _PsumGrad.apply(x, _axes(axis))


def _spec_dims(spec: tuple) -> list[tuple[int, tuple[str, ...], int]]:
    """(dim, mesh axes, ranks) of each array axis a partition spec splits
    over more than one rank of the current mesh; an axis of one rank is
    left out (it moves nothing and changes no index)."""
    out = []
    for dim, entry in enumerate(spec or ()):
        axes = tuple(a for a in (() if entry is None else _axes(entry))
                     if axis_size(a) > 1)
        if axes:
            out.append((dim, axes, axis_size(axes)))
    return out


class BlockedSpec(tuple):
    """A partition spec whose array is ``blocks`` arrays laid end to end
    along dimension ``dim`` (a fused projection, such as the hybrid's
    ``w_in`` = [z | y]): ``spec_slice`` gives a rank its part of each block
    along that dimension, side by side, and ``spec_gather`` puts the
    blocks back.  As a tuple it is the partition spec itself, so that it
    compares equal to the reference's spec of the same leaf."""

    def __new__(cls, spec, dim: int, blocks: int):
        out = super().__new__(cls, spec)
        out.dim, out.blocks = dim, blocks
        return out

    def __getnewargs__(self):
        return tuple(self), self.dim, self.blocks


def _blocks(spec, dim: int) -> int:
    return spec.blocks if isinstance(spec, BlockedSpec) and \
        spec.dim == dim else 1


def spec_slice(x: torch.Tensor, spec: tuple) -> torch.Tensor:
    """This rank's part of the whole array ``x`` under a partition spec on
    the current mesh (a view, except along a ``BlockedSpec``'s blocked
    dimension), as a ``NamedSharding`` places it."""
    for dim, axes, count in _spec_dims(spec):
        blocks = _blocks(spec, dim)
        if x.shape[dim] % (count * blocks):
            raise ValueError(f"axis {dim} of size {x.shape[dim]} does not "
                             f"split over {count} ranks of {axes}"
                             + (f" in {blocks} blocks" if blocks > 1
                                else ""))
        size = x.shape[dim] // (count * blocks)
        if blocks == 1:
            x = x.narrow(dim, axis_index(axes) * size, size)
        else:
            x = x.unflatten(dim, (blocks, count * size)).narrow(
                dim + 1, axis_index(axes) * size, size).flatten(dim, dim + 1)
    return x


def spec_gather(x: torch.Tensor, spec: tuple) -> torch.Tensor:
    """The whole array from every rank's part ``x`` under a partition spec
    (the inverse of ``spec_slice``); ``x`` itself where nothing is split."""
    for dim, axes, _ in _spec_dims(spec):
        parts = all_gather(x.contiguous(), axes)
        blocks = _blocks(spec, dim)
        if blocks > 1:
            parts = parts.unflatten(dim + 1, (blocks, -1)).movedim(0, dim + 1)
            x = parts.flatten(dim + 1, dim + 2).flatten(dim, dim + 1)
        else:
            x = torch.cat(list(parts.unbind(0)), dim=dim)
    return x


def _placed(whole: torch.Tensor, part: torch.Tensor, spec: tuple,
            coords: dict) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """(region of ``whole``, region of ``part``) pairs that put the part of
    the rank at ``coords`` ({axis: index}) in its place under ``spec``
    (block by block along a ``BlockedSpec``'s dimension)."""
    sizes = mesh_sizes(current_mesh())
    pairs = [(whole, part)]
    for dim, axes, count in _spec_dims(spec):
        index = 0
        for a in axes:
            index = index * sizes[a] + coords[a]
        blocks = _blocks(spec, dim)
        size = whole.shape[dim] // (count * blocks)
        pairs = [(w.narrow(dim, b * count * size + index * size, size),
                  p.narrow(dim, b * size, size))
                 for w, p in pairs for b in range(blocks)]
    return pairs


def spec_gather_first(x: torch.Tensor, spec: tuple) -> torch.Tensor | None:
    """The whole array of ``spec_gather``, on the first rank of the current
    mesh only (None on the others), in host memory under gloo: each rank
    holding a distinct part sends it once, to that rank (a rank whose
    coordinates are 0 on every axis ``spec`` does not split), where
    ``spec_gather`` sends every part to every rank.  For a checkpoint,
    which one rank writes.  The mesh must span every rank."""
    mesh = current_mesh()
    order = [int(r) for r in mesh.mesh.flatten()]
    if len(order) != dist.get_world_size():
        raise NotImplementedError("a mesh that does not span every rank")
    first, me = order[0], dist.get_rank()
    dims = _spec_dims(spec)
    if not dims:
        return x if me == first else None
    split = {a for _, axes, _ in dims for a in axes}
    names = tuple(mesh.mesh_dim_names)

    def coords_of(rank: int) -> dict:
        at = (mesh.mesh == rank).nonzero()[0].tolist()
        return dict(zip(names, at))

    part = x.detach().contiguous()
    if _staged(part):
        part = _to_host(part)
    senders = [r for r in order
               if all(c == 0 for a, c in coords_of(r).items()
                      if a not in split)]
    if me != first:
        if me in senders:
            dist.send(part, dst=first)
        return None
    shape = list(part.shape)
    for dim, _, count in dims:
        shape[dim] *= count
    whole = torch.empty(shape, dtype=part.dtype, device=part.device)
    for r in senders:
        got = part if r == me else torch.empty_like(part)
        if r != me:
            dist.recv(got, src=r)
        for w, p in _placed(whole, got, spec, coords_of(r)):
            w.copy_(p)
    return whole


def spec_shards(spec: tuple) -> bool:
    """Whether a partition spec splits an array over more than one rank of
    the current mesh."""
    return bool(_spec_dims(spec))


def barrier() -> None:
    """Every rank of the current mesh waits for the others."""
    mesh = current_mesh()
    device = "cuda" if mesh.device_type == "cuda" else "cpu"
    psum(torch.zeros(1, device=device), tuple(mesh.mesh_dim_names))


# ---------------------------------------------------------------------------
# Starting ranks
# ---------------------------------------------------------------------------


def rank_device(device: torch.device | str | None,
                rank: int) -> torch.device:
    """A rank's device: ``None`` is a card (``cuda:rank`` modulo the cards,
    so every rank lies on ``cuda:0`` of a one-card machine), and raises
    where there is none."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found for the ranks (pass "
                           "device='cpu' to run them on the CPU)")
    return torch.device("cuda", rank % torch.cuda.device_count())


def _rank_main(rank: int, fn: Callable, world: int, backend: str,
               device, init_dir: str, timeout: float, args: tuple,
               env: dict) -> None:
    os.environ.update(env)
    os.environ["OMP_NUM_THREADS"] = "1"
    torch.set_num_threads(1)
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=f"file://{os.path.join(init_dir, 'rdv')}",
        rank=rank, world_size=world, timeout=timedelta(seconds=timeout))
    try:
        result = fn(dev, *args)
        with open(os.path.join(init_dir, f"result.{rank}"), "wb") as f:
            pickle.dump(result, f)
    finally:
        set_mesh(None)
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, *, backend: str | None = None,
          device: torch.device | str | None = None,
          init_dir: str | None = None, args: tuple = (),
          timeout: float = TIMEOUT_S, env: dict | None = None) -> list:
    """Run ``fn(device, *args)`` in ``world`` new processes, one a rank of a
    ``torch.distributed`` group, and return their return values by rank
    (each pickled; move tensors to the CPU first).

    ``device`` None puts each rank on a card (``rank_device``); the tests
    pass ``"cpu"``.  ``backend`` None is NCCL for ranks on cards and gloo on
    the CPU; NCCL refuses two ranks on one card, where gloo (which stages
    through the host) is the choice.  The rendezvous is a file in
    ``init_dir`` (a new temporary directory when None, removed after).
    The group's collectives and the join each wait at most ``timeout``
    seconds; a rank that fails or a join that runs out makes this raise,
    with every rank stopped.  ``env`` is set in each rank's environment
    before it touches a card (such as ``PYTORCH_CUDA_ALLOC_CONF``)."""
    if device is None and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found for the ranks (pass "
                           "device='cpu' to run them on the CPU)")
    if backend is None:
        on_cpu = device is not None and torch.device(device).type == "cpu"
        backend = "gloo" if on_cpu else "nccl"
    own_dir = init_dir is None
    init_dir = tempfile.mkdtemp(prefix="ranks-") if own_dir else init_dir
    os.makedirs(init_dir, exist_ok=True)
    for name in os.listdir(init_dir):
        if name == "rdv" or name.startswith("result."):
            os.remove(os.path.join(init_dir, name))
    import torch.multiprocessing as mp

    ctx = mp.start_processes(
        _rank_main, args=(fn, world, backend, device, init_dir, timeout,
                          tuple(args), dict(env or {})),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{world} ranks did not finish in "
                                   f"{timeout} s")
        out = []
        for rank in range(world):
            with open(os.path.join(init_dir, f"result.{rank}"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
        for p in ctx.processes:
            p.join(5)
            if p.is_alive():
                p.kill()
        if own_dir:
            shutil.rmtree(init_dir, ignore_errors=True)

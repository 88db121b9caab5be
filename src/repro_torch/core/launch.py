"""Distributed kernel launches (paper §2.1, §3) on PyTorch.

The user-facing model mirrors the paper's host API (Fig. 9):

    ctx = Context()                               # host runtime, on the GPU
    k = KernelDef.define("stencil", body,
                  "global i => read input[i-1:i+1], write output[i]")
    out = ctx.launch(k, grid=(n,), work_dist=..., args={...})

``Context`` is the paper's host-side runtime: it owns array metadata,
invokes the planner for every launch, records the stitched task DAG
(sequential consistency via chunk-conflict edges), and dispatches
execution:

* **one worker** — the kernel body runs once on full-array views (the
  planner still runs, so plans and DAGs are inspectable);
* **a mesh of workers** (:mod:`~repro_torch.core.mesh`; ``num_workers=k``
  is a 1-D mesh ``("data",)`` of k workers on ``device``) — one controller
  runs each worker's superblock as its own call of the body, as the
  reference's one ``shard_map`` does on each device, and the planner's
  per-argument :class:`CommPattern` decides what each worker's view is:

    LOCAL       its shard (no communication)
    REPLICATED  the full array (storage is replicated)
    GATHER      the shards concatenated along the sharded axes
    HALO        its shard with ``h`` rows of each neighbour's on either
                side, zeros at the two end shards
    REDUCE      its partial buffer; the body's partials are combined with
                ``reduce(op)`` across the workers (``collective_reduce``)

Each worker's body makes its own kernel calls, so a launch over k workers
launches each kernel k times; workers on one GPU run one after another on
its current stream.

* **a rank mesh** (``Context(mesh=<DeviceMesh>)``, the ``DeviceMesh`` of
  ``repro_torch.launch.mesh.make_mesh`` over ``torch.distributed`` ranks)
  — the reference's ``shard_map`` as SPMD: every rank calls
  ``Context.launch`` alike, holds only its own shards and runs its own
  superblock's body.  The patterns are carried by the collectives of
  :mod:`repro_torch.dist.ranks`: HALO by two ``ppermute`` chains along the
  first mesh axis, GATHER by ``all_gather_tiled`` over each sharded
  dimension's axes, REDUCE by ``collective_reduce_ranks`` (``psum``,
  ``pmin``, ``pmax``, or a gather and a product).  Each emits a
  ``collective:halo`` / ``collective:gather`` / ``collective:reduce`` span
  on stream ``dist`` with the bytes it sends.  A written output is the
  rank's shard under its spec; a reduced one is held whole by every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.dist import ranks
from repro_torch.obs.metrics import MetricsRegistry, default_registry
from repro_torch.obs.trace import NULL_TRACER

from . import annotations as ann_mod
from .annotations import REDUCE as MODE_REDUCE, Annotation
from .dist_array import DistributedArray, full_array, make_array
from .distributions import Distribution, ReplicatedDist
from .faults import FaultInjector, InjectedError, RecoveryPolicy
from .mesh import (
    Mesh,
    assemble,
    is_rank_mesh,
    local_worker,
    make_mesh,
    mesh_coords,
    mesh_shape,
    mesh_size,
    shard_of,
    spec_axes,
)
from .plan_ir import CommPattern, ExecutionPlan, LaunchPlan
from .planner import Planner, Topology
from .reductions import collective_reduce, collective_reduce_ranks
from .superblock import EvenWork, WorkDistribution


@dataclasses.dataclass(frozen=True)
class KernelDef:
    """A Lightning kernel: a callable body plus its data annotation.

    ``body(views, info)`` receives ``views``: dict arg-name → tensor
    covering that argument's access region for this superblock (local
    coordinates), and ``info``: a :class:`SuperblockInfo`.  It returns a dict
    arg-name → tensor for each *written* argument (for ``reduce`` arguments
    it returns the local partial over the full output region).  The body
    must not write into its views: launches are functional updates.

    The body may be plain tensor code or a ``repro_torch.kernels`` wrapper.
    """

    name: str
    body: Callable[..., Mapping[str, torch.Tensor]]
    annotation: Annotation
    scalars: tuple[str, ...] = ()  # non-array parameters, passed through

    @staticmethod
    def define(
        name: str,
        body: Callable[..., Mapping[str, torch.Tensor]],
        annotation: str,
        scalars: Sequence[str] = (),
    ) -> "KernelDef":
        return KernelDef(name, body, ann_mod.parse(annotation), tuple(scalars))


@dataclasses.dataclass(frozen=True)
class SuperblockInfo:
    """Launch-local context handed to kernel bodies (the paper's
    ``virtBlockIdx`` + offset constants)."""

    grid: tuple[int, ...]  # full launch grid (threads)
    thread_offset: tuple[Any, ...]  # global index of this superblock's origin
    local_shape: tuple[int, ...]  # threads in this superblock
    device_index: Any  # flat worker id over the context's mesh axes
    scalars: dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class LaunchRecord:
    """What the context remembers about one launch (for tests/inspection)."""

    plan: LaunchPlan
    in_specs: dict[str, tuple]
    out_specs: dict[str, tuple]
    comm: dict[str, CommPattern]


class Context:
    """The host runtime: array registry + planner + launch execution."""

    def __init__(
        self,
        mesh: Mesh | None = None,
        mesh_axes: Sequence[str] | None = None,
        devices_per_node: int = 4,
        fault_injector: FaultInjector | None = None,
        recovery: RecoveryPolicy | None = None,
        tracer=None,
        registry: MetricsRegistry | None = None,
        plan_cache: bool = True,
        *,
        device: torch.device | str | None = None,
        num_workers: int = 1,
    ):
        """The reference's parameters, in its order (``Context(mesh)``
        works as there); the port's own two are keyword-only.  ``device``
        holds the global arrays (None: the GPU, or the mesh's first
        worker's device); ``num_workers=k`` is shorthand for a 1-D mesh
        ``("data",)`` of k workers, all on ``device``.  On a rank mesh
        ``device`` holds this rank's shards, and None is the rank's card
        (``ranks.rank_device``), which raises where there is none."""
        if num_workers < 1:
            raise ValueError(f"num_workers must be at least 1, got "
                             f"{num_workers}")
        if num_workers != 1:
            if mesh is not None:
                raise ValueError("give a mesh or num_workers, not both")
            mesh = make_mesh((num_workers,), ("data",), device)
        if is_rank_mesh(mesh):
            self.device = ranks.rank_device(
                device, torch.distributed.get_rank())
        elif mesh is not None and device is None:
            self.device = mesh.devices.flat[0]
        else:
            self.device = resolve_device(device)
        self.mesh = mesh
        self.mesh_axes = tuple(mesh_axes or (
            tuple(mesh_shape(mesh)) if mesh is not None else ()))
        # Observability: launches emit plan/execute spans on the ``driver``
        # stream and count launches/retries/recoveries on the registry
        # (resolved lazily so ``use_registry`` redirects us too).
        self.tracer = tracer or NULL_TRACER
        self._registry = registry
        # Fault tolerance: with an injector threaded in, failed kernel
        # launches retry under `recovery` instead of propagating; every
        # failure/recovery is recorded in `fault_events`.
        self.fault_injector = fault_injector
        self.recovery = recovery or RecoveryPolicy()
        self.fault_events: list[dict] = []
        self.topology = Topology(mesh_size(mesh) if mesh is not None else 1,
                                 devices_per_node)
        # Plan caching (repeated launches skip re-planning) shares this
        # context's registry so hit/miss counters land with the launch ones.
        self.planner = Planner(self.topology, registry=registry,
                               cache_plans=plan_cache)
        self.records: list[LaunchRecord] = []
        # One shared plan across launches: the planner stitches consecutive
        # launches with chunk-conflict edges (sequential consistency).
        self.plan = ExecutionPlan(launch_name="driver")
        self._array_counter = 0

    # -- array factory (paper: context.ones / zeros) ---------------------------

    @property
    def registry(self) -> MetricsRegistry:
        return self._registry if self._registry is not None \
            else default_registry()

    @property
    def num_devices(self) -> int:
        return self.topology.num_devices

    def _fresh_name(self, prefix: str) -> str:
        self._array_counter += 1
        return f"{prefix}_{self._array_counter}"

    def array(
        self,
        value: torch.Tensor | np.ndarray,
        dist: Distribution | None = None,
        name: str | None = None,
    ) -> DistributedArray:
        dist = dist or ReplicatedDist()
        return make_array(
            name or self._fresh_name("arr"), value, dist, device=self.device,
            mesh=self.mesh, mesh_axes=self.mesh_axes,
        )

    def zeros(self, shape, dtype=torch.float32, dist=None, name=None):
        return self.full(shape, 0, dtype, dist, name)

    def ones(self, shape, dtype=torch.float32, dist=None, name=None):
        return self.full(shape, 1, dtype, dist, name)

    def full(self, shape, fill, dtype=torch.float32, dist=None, name=None):
        """An array of ``fill``; on a rank mesh only this rank's shard is
        allocated."""
        return full_array(
            name or self._fresh_name("arr"), shape, fill, dtype,
            dist or ReplicatedDist(), self.mesh, self.mesh_axes,
            device=self.device)

    # -- launch ------------------------------------------------------------------

    def launch(
        self,
        kernel: KernelDef,
        grid: Sequence[int],
        args: Mapping[str, DistributedArray],
        work_dist: WorkDistribution | None = None,
        work_axis: int = 0,
        scalars: Mapping[str, Any] | None = None,
        block_shape: Sequence[int] | None = None,
    ) -> dict[str, DistributedArray]:
        """Distributed kernel launch.  Returns new values for every written
        array (functional update — "writes" produce replacements and the
        inputs stay as they were, which is what makes a retry safe)."""
        grid = tuple(int(g) for g in grid)
        work_dist = work_dist or EvenWork(axis=work_axis)
        scalars = dict(scalars or {})
        arrays = {name: a.meta() for name, a in args.items()}

        with self.tracer.span(f"plan:{kernel.name}", stream="driver",
                              cat="sched", grid=list(grid)):
            plan = self.planner.plan_launch(
                kernel.name, kernel.annotation, grid, work_dist, arrays,
                block_shape=block_shape, plan=self.plan,
            )
        comm = {a.array: a.pattern for a in plan.args}
        self.registry.counter("launch.count").labels(
            kernel=kernel.name).inc()

        with self.tracer.span(f"launch:{kernel.name}", stream="driver",
                              cat="compute", grid=list(grid),
                              devices=self.num_devices):
            if self.mesh is None or mesh_size(self.mesh) == 1:
                outputs = self._with_recovery(
                    kernel, lambda: self._execute_single(kernel, grid, args,
                                                         scalars)
                )
                in_specs = {n: () for n in args}
                out_specs = {n: () for n in outputs}
            elif is_rank_mesh(self.mesh):
                outputs, in_specs, out_specs = self._with_recovery(
                    kernel, lambda: self._execute_ranks(kernel, grid, args,
                                                        scalars, plan,
                                                        work_dist)
                )
            else:
                outputs, in_specs, out_specs = self._with_recovery(
                    kernel, lambda: self._execute_mesh(kernel, grid, args,
                                                       scalars, plan,
                                                       work_dist)
                )

        self.records.append(
            LaunchRecord(plan=plan, in_specs=in_specs, out_specs=out_specs,
                         comm=comm)
        )
        result: dict[str, DistributedArray] = {}
        for name, val in outputs.items():
            result[name] = args[name].replace_value(val)
        return result

    def _with_recovery(self, kernel: KernelDef, attempt_fn: Callable[[], Any]):
        """Run one launch attempt, retrying failed launches.

        With no injector this is a plain call (zero behavioral change).
        With one, injected ``launch`` probes — and any real exception the
        attempt raises — retry up to ``recovery.max_attempts`` times before
        propagating.  Launches are functional (bodies and kernel wrappers
        allocate their outputs and never write into an input), so
        re-execution is always safe.

        On a rank mesh only injected failures retry.  The probe comes
        before the attempt and, with the same injector and seed on every
        rank, decides alike on all of them, so they retry together and
        their ``fault_events`` agree.  A real exception raised on one rank
        propagates at once: the others may be waiting in a collective of
        the attempt, which no retry could rejoin, and ``ranks.spawn`` stops
        every rank within its timeout."""
        if self.fault_injector is None:
            return attempt_fn()
        ranked = is_rank_mesh(self.mesh) and mesh_size(self.mesh) > 1
        attempt = 0
        while True:
            try:
                if self.fault_injector.probe(
                    "launch", task=len(self.records), site=kernel.name
                ):
                    raise InjectedError(
                        f"injected launch failure: {kernel.name}"
                    )
                result = attempt_fn()
            except Exception as exc:  # noqa: BLE001 — retried, then re-raised
                if ranked and not isinstance(exc, InjectedError):
                    raise
                attempt += 1
                self.fault_events.append({
                    "kind": "launch_failure", "launch": kernel.name,
                    "attempt": attempt, "error": repr(exc),
                })
                self.registry.counter("launch.retries").labels(
                    kernel=kernel.name).inc()
                if self.tracer.enabled:
                    self.tracer.instant(
                        f"launch_failure:{kernel.name}", ts=self.tracer.now(),
                        stream="driver", cat="fault",
                        args={"attempt": attempt},
                    )
                if attempt > self.recovery.max_attempts:
                    raise
                continue
            if attempt:
                self.fault_events.append({
                    "kind": "launch_recovered", "launch": kernel.name,
                    "attempt": attempt,
                })
                self.registry.counter("launch.recoveries").labels(
                    kernel=kernel.name).inc()
            return result

    def synchronize(self, *arrays: DistributedArray) -> None:
        """Block until dispatched work completes (paper Fig. 9 line 21):
        a synchronise of the context's device and of every CUDA device of
        its mesh (on a rank mesh, of the rank's own device).  ``arrays``
        are accepted for the reference's call shape; kernels are enqueued
        in order on each device, so waiting for the devices covers them."""
        devices = {self.device}
        if self.mesh is not None and not is_rank_mesh(self.mesh):
            devices.update(self.mesh.worker_devices())
        for device in devices:
            if device.type == "cuda":
                torch.cuda.synchronize(device)

    # -- single-device execution ---------------------------------------------------

    def _execute_single(
        self,
        kernel: KernelDef,
        grid: tuple[int, ...],
        args: Mapping[str, DistributedArray],
        scalars: dict[str, Any],
    ) -> dict[str, torch.Tensor]:
        views = {name: a.value for name, a in args.items()}
        info = SuperblockInfo(
            grid=grid,
            thread_offset=(0,) * len(grid),
            local_shape=grid,
            device_index=0,
            scalars=scalars,
        )
        outs = dict(kernel.body(views, info))
        # reduce() partials on one device are already the full reduction.
        return outs

    # -- mesh execution --------------------------------------------------------------

    def _execute_mesh(
        self,
        kernel: KernelDef,
        grid: tuple[int, ...],
        args: Mapping[str, DistributedArray],
        scalars: dict[str, Any],
        plan: LaunchPlan,
        work_dist: WorkDistribution,
    ) -> tuple[dict[str, torch.Tensor], dict[str, tuple], dict[str, tuple]]:
        """The reference's ``_execute_mesh`` on one controller: each worker's
        body runs on its views in turn, then the written outputs are
        combined (REDUCE), taken from worker 0 (replicated) or concatenated
        along their specs."""
        mesh = self.mesh
        assert mesh is not None
        axes = self.mesh_axes
        patterns = {a.array: a for a in plan.args}
        in_specs, out_specs, written = _specs(kernel, args, patterns)

        n_shards = mesh.size
        shards = {name: [shard_of(arr.value, in_specs[name], mesh, w)
                         for w in range(n_shards)]
                  for name, arr in args.items()}
        per_worker = []
        for w in range(n_shards):
            info = _superblock(grid, scalars, work_dist, mesh, axes, w)
            views: dict[str, torch.Tensor] = {}
            for name, arr in args.items():
                ap = patterns[name]
                if ap.pattern in (CommPattern.LOCAL, CommPattern.REPLICATED,
                                  CommPattern.REDUCE):
                    # REDUCE: the partial buffer, which the body replaces
                    views[name] = shards[name][w]
                elif ap.pattern is CommPattern.HALO:
                    views[name] = _halo_exchange(
                        shards[name], w, ap.halo_width or (1,), axes, mesh)
                else:
                    # GATHER, and SCATTER and the rest by the gather
                    # fallback: every shard, i.e. the global array (itself
                    # where the worker lies on its device: bodies never
                    # write their views)
                    views[name] = arr.value.to(mesh.devices.flat[w])
            outs = dict(kernel.body(views, info))
            per_worker.append([outs[name] for name in written])

        outputs: dict[str, torch.Tensor] = {}
        for k, name in enumerate(written):
            ap = patterns[name]
            pieces = [outs[k] for outs in per_worker]
            if ap.pattern is CommPattern.REDUCE or ap.mode == MODE_REDUCE:
                outputs[name] = collective_reduce(
                    ap.reduce_op or "+", pieces, axes).to(self.device)
            else:
                outputs[name] = assemble(pieces, out_specs[name], mesh,
                                         self.device)
        return outputs, in_specs, out_specs

    # -- execution over ranks ---------------------------------------------------------

    def _execute_ranks(
        self,
        kernel: KernelDef,
        grid: tuple[int, ...],
        args: Mapping[str, DistributedArray],
        scalars: dict[str, Any],
        plan: LaunchPlan,
        work_dist: WorkDistribution,
    ) -> tuple[dict[str, torch.Tensor], dict[str, tuple], dict[str, tuple]]:
        """The reference's ``shard_body`` in this rank: its views from its
        own shards and the collectives each pattern needs, its
        superblock's body, then its outputs: a written one is its shard
        under ``out_spec``, a reduced one the combined whole (sliced to the
        rank's shard where the array's own spec splits it, so that
        ``value`` is always the shard under ``partition_spec()``)."""
        mesh, axes = self.mesh, self.mesh_axes
        patterns = {a.array: a for a in plan.args}
        in_specs, out_specs, written = _specs(kernel, args, patterns)
        me = local_worker(mesh)
        info = _superblock(grid, scalars, work_dist, mesh, axes, me)
        span = dict(worker=me, stream="dist", cat="dist")
        with ranks.use_mesh(mesh):
            views: dict[str, torch.Tensor] = {}
            for name, arr in args.items():
                pattern = patterns[name].pattern
                held = arr.partition_spec()
                if pattern is CommPattern.HALO:
                    halo = patterns[name].halo_width or (1,)
                    views[name] = _halo_exchange_ranks(
                        arr.value, halo, axes, self.tracer, span)
                elif pattern in (CommPattern.LOCAL, CommPattern.REDUCE) or \
                        not any(map(spec_axes, held)):
                    # REDUCE: the partial buffer, which the body replaces
                    views[name] = arr.value
                else:
                    # GATHER, REPLICATED of a split array, and SCATTER and
                    # the rest by the gather fallback: every shard
                    views[name] = _gather_ranks(arr.value, held, self.tracer,
                                                span)
            outs = dict(kernel.body(views, info))
            outputs: dict[str, torch.Tensor] = {}
            for name in written:
                ap, out = patterns[name], outs[name]
                if ap.pattern is CommPattern.REDUCE or ap.mode == MODE_REDUCE:
                    with self.tracer.span(
                            "collective:reduce", op=ap.reduce_op or "+",
                            bytes=out.numel() * out.element_size(), **span):
                        out = collective_reduce_ranks(ap.reduce_op or "+",
                                                      out, axes)
                held = args[name].partition_spec()
                if not out_specs[name] and any(map(spec_axes, held)):
                    out = shard_of(out, held, mesh, me).contiguous()
                outputs[name] = out
        return outputs, in_specs, out_specs


def _specs(kernel: KernelDef, args: Mapping[str, DistributedArray],
           patterns: Mapping[str, Any]):
    """(in_specs, out_specs, written) of a launch on a mesh, as the
    reference's ``_execute_mesh`` derives them: a REPLICATED argument's
    spec is (), a reduced or replicated output's () (one result, held by
    every worker), every other its array's partition spec."""
    in_specs = {
        name: () if patterns[name].pattern is CommPattern.REPLICATED
        else arr.partition_spec()
        for name, arr in args.items()
    }
    written = [s.array for s in kernel.annotation.stmts if s.writes]
    out_specs: dict[str, tuple] = {}
    for name in written:
        ap = patterns[name]
        if (ap.pattern in (CommPattern.REDUCE, CommPattern.REPLICATED)
                or ap.mode == MODE_REDUCE):
            out_specs[name] = ()
        else:
            out_specs[name] = args[name].partition_spec()
    return in_specs, out_specs, written


def _superblock(grid: tuple[int, ...], scalars: dict[str, Any],
                work_dist: WorkDistribution, mesh, axes: Sequence[str],
                worker: int) -> SuperblockInfo:
    """Worker ``worker``'s superblock: its flat index over ``axes`` (the
    reference's ``idx * mesh.shape[ax] + axis_index(ax)``), and its share
    of the one grid axis the work distribution splits over all the
    workers."""
    coords, shape = mesh_coords(mesh, worker), mesh_shape(mesh)
    idx = coords[axes[0]]
    for ax in axes[1:]:
        idx = idx * shape[ax] + coords[ax]
    split_axis = getattr(work_dist, "axis", 0)
    sb_threads = grid[split_axis] // mesh_size(mesh)
    offset = [0] * len(grid)
    offset[split_axis] = idx * sb_threads
    local_shape = list(grid)
    local_shape[split_axis] = sb_threads
    return SuperblockInfo(grid=grid, thread_offset=tuple(offset),
                          local_shape=tuple(local_shape), device_index=idx,
                          scalars=scalars)


def _gather_ranks(x: torch.Tensor, spec: tuple, tracer,
                  span: dict) -> torch.Tensor:
    """The whole array from every rank's shard ``x`` under ``spec``: a
    tiled gather over each sharded dimension's axes (the reference's
    ``all_gather(..., tiled=True)``), in ``shard_index``'s order."""
    with tracer.span("collective:gather",
                     bytes=x.numel() * x.element_size(), **span):
        return ranks.spec_gather(x, spec)


def _halo_exchange_ranks(x: torch.Tensor, halo: tuple[int, ...],
                         axes: Sequence[str], tracer,
                         span: dict) -> torch.Tensor:
    """This rank's shard with ``halo`` cells of its +-1 neighbours along
    the first mesh axis on either side, by two ``ranks.ppermute`` chains:
    each rank's last cells to the next rank, its first to the previous.
    The two end shards receive zeros: no rank sends to them, where the
    reference's rings send around and zero what arrives."""
    axis = axes[0]
    n = ranks.axis_size(axis)
    h = next((v for v in halo if v), 1)
    dim = next((i for i, v in enumerate(halo) if v), 0)
    first = x.narrow(dim, 0, h)
    last = x.narrow(dim, x.shape[dim] - h, h)
    with tracer.span("collective:halo", bytes=2 * last.numel()
                     * last.element_size(), **span):
        from_left = ranks.ppermute(last, axis,
                                   [(i, i + 1) for i in range(n - 1)])
        from_right = ranks.ppermute(first, axis,
                                    [(i + 1, i) for i in range(n - 1)])
    return torch.cat([from_left, x, from_right], dim=dim)


def _halo_exchange(
    shards: Sequence[torch.Tensor],
    worker: int,
    halo: tuple[int, ...],
    axes: Sequence[str],
    mesh: Mesh,
) -> torch.Tensor:
    """The worker's shard with ``halo`` cells of its +-1 neighbours along
    the first mesh axis concatenated on either side (1-D decomposition, the
    paper's stencil distribution).  The two end shards receive zeros, as in
    the reference (its kernels' bounds checks are meant to ignore them)."""
    axis = axes[0]
    n = mesh.shape[axis]
    h = next((v for v in halo if v), 1)
    dim = next((i for i, v in enumerate(halo) if v), 0)
    x = shards[worker]
    coords = mesh.coords(worker)
    here = coords[axis]

    def neighbour(step: int) -> torch.Tensor:
        return shards[mesh.worker_at({**coords, axis: (here + step) % n})]

    left = neighbour(-1)
    from_left = left.narrow(dim, left.shape[dim] - h, h).to(x.device)
    from_right = neighbour(1).narrow(dim, 0, h).to(x.device)
    if here == 0:
        from_left = torch.zeros_like(from_left)
    if here == n - 1:
        from_right = torch.zeros_like(from_right)
    return torch.cat([from_left, x, from_right], dim=dim)

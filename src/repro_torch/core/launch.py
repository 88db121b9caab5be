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
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.obs.metrics import MetricsRegistry, default_registry
from repro_torch.obs.trace import NULL_TRACER

from . import annotations as ann_mod
from .annotations import REDUCE as MODE_REDUCE, Annotation
from .dist_array import DistributedArray, make_array
from .distributions import Distribution, ReplicatedDist
from .faults import FaultInjector, RecoveryPolicy
from .mesh import Mesh, assemble, make_mesh, shard_of
from .plan_ir import CommPattern, ExecutionPlan, LaunchPlan
from .planner import Planner, Topology
from .reductions import collective_reduce
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
        device: torch.device | str | None = None,
        mesh: Mesh | None = None,
        mesh_axes: Sequence[str] | None = None,
        num_workers: int = 1,
        devices_per_node: int = 4,
        fault_injector: FaultInjector | None = None,
        recovery: RecoveryPolicy | None = None,
        tracer=None,
        registry: MetricsRegistry | None = None,
        plan_cache: bool = True,
    ):
        """``device`` holds the global arrays (None: the GPU, or the mesh's
        first worker's device).  ``mesh``/``mesh_axes`` are the reference's
        keywords; ``num_workers=k`` is shorthand for a 1-D mesh
        ``("data",)`` of k workers, all on ``device``."""
        if num_workers < 1:
            raise ValueError(f"num_workers must be at least 1, got "
                             f"{num_workers}")
        if num_workers != 1:
            if mesh is not None:
                raise ValueError("give a mesh or num_workers, not both")
            mesh = make_mesh((num_workers,), ("data",), device)
        if mesh is not None and device is None:
            self.device = mesh.devices.flat[0]
        else:
            self.device = resolve_device(device)
        self.mesh = mesh
        self.mesh_axes = tuple(mesh_axes or (mesh.axis_names if mesh else ()))
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
        self.topology = Topology(mesh.size if mesh else 1, devices_per_node)
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
        return self.array(
            torch.zeros(shape, dtype=dtype, device=self.device), dist, name)

    def ones(self, shape, dtype=torch.float32, dist=None, name=None):
        return self.array(
            torch.ones(shape, dtype=dtype, device=self.device), dist, name)

    def full(self, shape, fill, dtype=torch.float32, dist=None, name=None):
        return self.array(
            torch.full(shape, fill, dtype=dtype, device=self.device),
            dist, name)

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
            if self.mesh is None or self.mesh.size == 1:
                outputs = self._with_recovery(
                    kernel, lambda: self._execute_single(kernel, grid, args,
                                                         scalars)
                )
                in_specs = {n: () for n in args}
                out_specs = {n: () for n in outputs}
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
        re-execution is always safe."""
        if self.fault_injector is None:
            return attempt_fn()
        attempt = 0
        while True:
            try:
                if self.fault_injector.probe(
                    "launch", task=len(self.records), site=kernel.name
                ):
                    raise RuntimeError(
                        f"injected launch failure: {kernel.name}"
                    )
                result = attempt_fn()
            except Exception as exc:  # noqa: BLE001 — retried, then re-raised
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
        its mesh.  ``arrays`` are accepted for the reference's call shape;
        kernels are enqueued in order on each device, so waiting for the
        devices covers them."""
        devices = {self.device}
        if self.mesh is not None:
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
        ann = kernel.annotation
        # The work distribution splits one grid axis over all the workers.
        split_axis = getattr(work_dist, "axis", 0)
        patterns = {a.array: a for a in plan.args}

        in_specs = {
            name: () if patterns[name].pattern is CommPattern.REPLICATED
            else arr.partition_spec()
            for name, arr in args.items()
        }
        written = [s.array for s in ann.stmts if s.writes]
        out_specs: dict[str, tuple] = {}
        for name in written:
            ap = patterns[name]
            if (ap.pattern in (CommPattern.REDUCE, CommPattern.REPLICATED)
                    or ap.mode == MODE_REDUCE):
                out_specs[name] = ()  # one result, held by every worker
            else:
                out_specs[name] = args[name].partition_spec()

        n_shards = mesh.size
        sb_threads = grid[split_axis] // n_shards
        shards = {name: [shard_of(arr.value, in_specs[name], mesh, w)
                         for w in range(n_shards)]
                  for name, arr in args.items()}
        per_worker = []
        for w in range(n_shards):
            coords = mesh.coords(w)
            idx = coords[axes[0]]
            for ax in axes[1:]:
                idx = idx * mesh.shape[ax] + coords[ax]
            offset = [0] * len(grid)
            offset[split_axis] = idx * sb_threads
            local_shape = list(grid)
            local_shape[split_axis] = sb_threads

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
            info = SuperblockInfo(
                grid=grid,
                thread_offset=tuple(offset),
                local_shape=tuple(local_shape),
                device_index=idx,
                scalars=scalars,
            )
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

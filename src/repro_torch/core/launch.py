"""Distributed kernel launches (paper §2.1, §3) on PyTorch.

The user-facing model mirrors the paper's host API (Fig. 9):

    ctx = Context()                               # host runtime, on the GPU
    k = KernelDef.define("stencil", body,
                  "global i => read input[i-1:i+1], write output[i]")
    out = ctx.launch(k, grid=(n,), work_dist=..., args={...})

``Context`` is the paper's host-side runtime: it owns array metadata,
invokes the planner for every launch, records the stitched task DAG
(sequential consistency via chunk-conflict edges), and dispatches
execution.  On one device the kernel body runs once on full-array views;
the planner still runs, so plans and DAGs are inspectable, and each
argument's :class:`CommPattern` is recorded:

    LOCAL       region lies in the locally owned chunk (no communication)
    REPLICATED  full array everywhere (storage is replicated)
    GATHER      region spans remote chunks
    HALO        local chunk plus a bounded edge from the neighbours
    REDUCE      kernel emits partials that are combined with ``reduce(op)``

Execution over several workers (ROADMAP Queue A item 7) is not in this
package yet: a ``Context`` asked for more than one worker raises.
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
from .annotations import Annotation
from .dist_array import DistributedArray, make_array
from .distributions import Distribution, ReplicatedDist
from .faults import FaultInjector, RecoveryPolicy
from .plan_ir import CommPattern, ExecutionPlan, LaunchPlan
from .planner import Planner, Topology
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
    device_index: Any  # flat worker id
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
        num_workers: int = 1,
        devices_per_node: int = 4,
        fault_injector: FaultInjector | None = None,
        recovery: RecoveryPolicy | None = None,
        tracer=None,
        registry: MetricsRegistry | None = None,
        plan_cache: bool = True,
    ):
        if num_workers != 1:
            raise NotImplementedError(
                "execution over several workers is not ported yet "
                "(ROADMAP Queue A item 7: _execute_mesh, _halo_exchange, "
                "collective_reduce)"
            )
        self.device = resolve_device(device)
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
        self.topology = Topology(num_workers, devices_per_node)
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
            outputs = self._with_recovery(
                kernel, lambda: self._execute_single(kernel, grid, args,
                                                     scalars)
            )
            in_specs = {n: () for n in args}
            out_specs = {n: () for n in outputs}

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
        a synchronise of the context's device.  ``arrays`` are accepted for
        the reference's call shape; kernels are enqueued in order on the
        device, so waiting for the device covers them."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

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

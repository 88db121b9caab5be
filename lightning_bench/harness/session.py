"""One process's part of a run: set-up, the measured window, the traced
slice, the checks of what the timed path produced, and the readings.

On one card the run is one such process; over ranks every rank runs one
(``rank_main``) and the parent combines their readings.  A session:

1. places the cell's data through the program (``app.place``), frees the
   draw's temporaries and starts the device's peak from there;
2. warms up with one application (the program's library is loaded and
   every shape the window uses is run once), and in a traced run starts
   and stops the profiler once;
3. runs applications back to back until ``seconds`` have passed, each
   timed from its start to the end of its ``ctx.synchronize()`` (over
   ranks, to the end of the flag exchange after it, which every rank
   reaches only when the slowest has finished), each application's
   results kept in host memory (``app.kept``) where every application is
   judged, so that the card holds none past it; a traced run profiles a
   slice of at least three applications and half a second, from the first
   application after a third of the window;
4. reads the device's peak, the program's counters and spans, frees the
   program's state, and judges what the timed path produced against the
   plain reference.
"""

from __future__ import annotations

import dataclasses
import gc
import sys
import time
from typing import Callable

import torch

from lightning_bench.harness import bench, peaks, profile

#: top-level module names that no run may hold (the JAX package is ``repro``)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: the profiled slice: at least this many applications and seconds
SLICE_APPS = 3
SLICE_SECONDS = 0.5


@dataclasses.dataclass
class Spec:
    """What a session runs; picklable, so that ranks can be handed it."""

    root: str
    workload: str
    seed: int
    seconds: float
    trace: bool
    sizes: dict | None = None  # over the configuration's sizes (tests)
    mix: dict | None = None  # over the traffic's parameters (tests)
    fault: Callable | None = None  # fault(app) plants a fault, returns
    # the function that mends it (tests)


@dataclasses.dataclass
class Readings:
    """What a session measured and checked, in host memory."""

    apps: list  # seconds of each application in the window
    window_s: float
    peak_bytes: int | None
    setup_end: float  # epoch seconds at the start of the window
    spans: list  # program and harness spans of the window
    counters: dict  # the program's registry over the window
    launches: int  # Context.launch calls in the window
    device: dict | None  # the profiled slice's reading
    work: dict  # app.work(...)
    peaks: dict | None
    checks: dict  # name -> [value, limit]
    failed: int  # kept applications that failed a check
    kind: str
    forbidden: list
    phases: dict  # seconds of set-up's parts and of the judgement
    setup_s: float | None = None  # set by the process that started the run


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


def _agree(flags: list[int], ctx) -> list[int]:
    """The flags, each the largest over the ranks (every rank waits for
    the slowest here); as they are in one process."""
    from repro_torch.core.mesh import is_rank_mesh

    if not is_rank_mesh(ctx.mesh):
        return flags
    t = torch.tensor(flags, dtype=torch.int32, device=ctx.device)
    torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MAX)
    return [int(v) for v in t.tolist()]


def _annotate(ctx, tracer) -> None:
    """Harness spans and profiler annotations around each
    ``Context.launch`` call and each ``ctx.synchronize()``."""
    launch, synchronize = ctx.launch, ctx.synchronize

    def traced_launch(kernel, *args, **kw):
        with tracer.span(f"bench:launch:{kernel.name}", stream="bench"), \
                torch.profiler.record_function(f"launch:{kernel.name}"):
            return launch(kernel, *args, **kw)

    def traced_synchronize(*arrays):
        with torch.profiler.record_function("sync"):
            return synchronize(*arrays)

    ctx.launch, ctx.synchronize = traced_launch, traced_synchronize


def run(spec: Spec, device: torch.device, mesh=None, world: int = 1,
        rank: int = 0) -> Readings:
    cell = bench.cell(spec.root, spec.workload)
    mend = spec.fault(cell.app) if spec.fault is not None else None
    try:
        return _run(spec, cell, device, mesh, world, rank)
    finally:
        if mend is not None:
            mend()


def _run(spec: Spec, cell: bench.Cell, device: torch.device, mesh,
         world: int, rank: int) -> Readings:
    from repro_torch.core import Context
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.obs.trace import Tracer

    t_begin = time.time()
    app, ref = cell.app, cell.reference
    params = {**cell.config, **(spec.sizes or {})}
    traffic = {**cell.traffic, **(spec.mix or {})}
    on_card = device.type == "cuda"
    registry = MetricsRegistry()
    tracer = Tracer(clock=time.perf_counter) if spec.trace else None
    ctx = Context(mesh=mesh, tracer=tracer, registry=registry, device=device)
    if tracer is not None:
        _annotate(ctx, tracer)

    # 1. placement; the device's peak counts from the placed data on
    t_place = time.time()
    state = app.place(ctx, params, traffic, spec.seed, world)
    ctx.synchronize()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    # 2. warm-up
    t_warm = time.time()
    app.run_app(ctx, state, params, traffic)
    if tracer is not None:
        profile.warm_up()
    _agree([0], ctx)
    setup_end = time.time()

    # 3. the window
    launches0, routes0 = app.launch_counters()
    reg0, rec0 = registry.snapshot(), len(ctx.records)
    keep, out = [], None
    apps: list[float] = []
    sl = profile.Slice() if tracer is not None else None
    slice_on, slice_t0, slice_n, reading = False, 0.0, 0, None
    t0 = time.perf_counter()
    while True:
        a0 = time.perf_counter()
        if sl is not None and reading is None and not slice_on \
                and a0 - t0 >= spec.seconds / 3:
            sl.start()
            slice_on, slice_t0 = True, a0
        if not app.KEEP_EVERY:
            out = None
        with torch.profiler.record_function("app"):
            if tracer is not None:
                with tracer.span("bench:app", stream="bench"):
                    out = app.run_app(ctx, state, params, traffic)
            else:
                out = app.run_app(ctx, state, params, traffic)
        now = time.perf_counter()
        done, ready = _agree([
            int(now - t0 >= spec.seconds),
            int(slice_on and slice_n + 1 >= SLICE_APPS
                and now - slice_t0 >= SLICE_SECONDS)], ctx)
        a1 = time.perf_counter()
        apps.append(a1 - a0)
        if app.KEEP_EVERY:
            keep.append(app.kept(out))
        if slice_on:
            slice_n += 1
            if ready or done:
                reading = sl.stop()
                slice_on = False
        if done:
            break
    window_s = a1 - t0

    # 4. readings, checks, the program's state freed, the judgement
    peak = torch.cuda.max_memory_allocated(device) if on_card else None
    launches1, routes1 = app.launch_counters()
    counters = MetricsRegistry.diff(registry.snapshot(), reg0)
    comm = ({name: p.value for name, p in ctx.records[-1].comm.items()}
            if len(ctx.records) > rec0 else {})
    n_launches = len(ctx.records) - rec0
    spans = [{"name": e["name"], "ts": e["ts"], "dur": e["dur"],
              "bytes": e["args"].get("bytes")}
             for e in (tracer.events if tracer is not None else [])
             if e["ph"] == "X" and e["ts"] >= t0]
    checks: dict = {}
    if on_card:
        want = app.launches_per_app(params, traffic, world) * len(apps)
        got = launches1 - launches0
        checks["launches_off"] = [abs(got - want), 0]
        if app.ROUTE is not None:
            by = routes1[app.ROUTE] - routes0.get(app.ROUTE, 0)
            checks["route_off"] = [got - by, 0]
    patterns = app.PATTERNS.get(traffic["placement"])
    if patterns is not None:
        checks["patterns_off"] = [sum(comm.get(a) != p
                                      for a, p in patterns.items()), 0]
    kept = keep if app.KEEP_EVERY else [app.kept(out)]
    del keep, out, state, ctx
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_judge = time.time()
    per_app = app.judge(kept, params, traffic, spec.seed, device, world, rank)
    phases = {"session_start": t_begin, "context": t_place - t_begin,
              "place": t_warm - t_place, "warm_up": setup_end - t_warm,
              "judge": time.time() - t_judge}
    failed = 0
    for gaps in per_app:
        failed += any(not v <= ref.LIMITS[k] for k, v in gaps.items())
        for k, v in gaps.items():
            checks[k] = [max(checks.get(k, [v])[0], v), ref.LIMITS[k]]
    kind = torch.cuda.get_device_name(device) if on_card else device.type
    return Readings(
        apps=apps, window_s=window_s, peak_bytes=peak, setup_end=setup_end,
        spans=spans, counters=counters, launches=n_launches, device=reading,
        work=app.work(params, traffic, world), peaks=peaks.PEAKS.get(kind),
        checks=checks, failed=failed, kind=kind,
        forbidden=forbidden_modules(), phases=phases)


def rank_main(device: torch.device, spec: Spec) -> Readings:
    """A rank's session on a 1-D ``("data",)`` mesh of every rank."""
    from repro_torch.launch.mesh import make_mesh

    world = torch.distributed.get_world_size()
    mesh = make_mesh((world,), ("data",))
    return run(spec, device, mesh, world, torch.distributed.get_rank())

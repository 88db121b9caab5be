"""Simulator scenarios for the parity tests, written once and run on either
package.

Each scenario takes a package namespace (:func:`package`: ``"repro"``, the
reference, or ``"repro_torch"``, the port) and returns plain data — the
makespan, the whole ``SimResult.stats`` dict, busy seconds, chunk tiers,
trace JSON, the class name and message of what was raised — so that the
two packages' answers compare with ``==``.  The simulator is deterministic,
so any difference is a copy error.  The scenarios follow the reference's
own tests (``tests/test_simulator.py``, ``test_overlap_engine.py``,
``test_d2d_fabric.py``, ``test_faults.py``) with the same inputs; every
hardware model is given explicitly (``small_hw``, ``paper_p100()``), never
the package's default, which differs between the two on purpose.
:data:`BENCH_SECTIONS` is ``benchmarks/bench_sim.py:collect()`` on either
package.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib
import random
import types

MB = 1 << 20
KMEANS_TEXT = ("global i => read points[i], read centroids[:], "
               "reduce(+) sums[i]")
STENCIL_TEXT = "global i => read inp[i-1:i+1], write out[i]"
MAP_TEXT = "global i => read inp[i], write out[i]"


@functools.lru_cache(maxsize=None)
def package(root: str) -> types.SimpleNamespace:
    """The modules a scenario reads, from ``root``."""
    def m(name):
        return importlib.import_module(f"{root}.{name}")

    return types.SimpleNamespace(
        root=root, core=m("core"), plan_ir=m("core.plan_ir"),
        memory=m("core.memory"), scheduler=m("core.scheduler"),
        metrics=m("obs.metrics"), trace=m("obs.trace"),
        overlap=m("obs.overlap"), validate=m("obs.validate"),
        fault=m("dist.fault"), obs=m("obs"),
    )


def result(res) -> dict:
    """Everything a ``SimResult`` carries."""
    return {"makespan": res.makespan, "busy": dict(res.busy),
            "task_count": res.task_count, "stats": dict(res.stats),
            "num_workers": res.num_workers,
            "utilization": res.utilization(),
            "recovery": res.recovery_stats()}


def raised(fn) -> tuple | None:
    """(class name, message) of what ``fn()`` raises, None if nothing."""
    try:
        fn()
    except Exception as exc:  # noqa: BLE001 — compared across packages
        return type(exc).__name__, str(exc)
    return None


def tiers(mm) -> dict:
    return {k: c.tier.name for k, c in sorted(mm.chunks.items())}


# ---------------------------------------------------------------------------
# Hardware models and plans (the reference tests' own)
# ---------------------------------------------------------------------------


def carried(P, hw):
    """The reference's hardware model ``hw`` as ``P``'s: every field
    copied, the nested ``Interconnect`` rebuilt on ``P``'s side."""
    fields = {f.name: getattr(hw, f.name) for f in dataclasses.fields(hw)}
    if fields["topology"] is not None:
        fields["topology"] = P.core.Interconnect(
            **dataclasses.asdict(fields["topology"]))
    return P.core.HardwareModel(**fields)


def reference_hw(P, **kw):
    """The reference's ``HardwareModel(**kw)`` as ``P``'s.  The reference
    tests' small models leave some fields at the reference's defaults,
    which the port does not share (its defaults are the H100's), so the
    port takes every field from the reference's model."""
    from repro.core import HardwareModel

    return carried(P, HardwareModel(**kw))


def small_hw(P, **kw):
    """``tests/test_simulator.py:small_hw``."""
    defaults = dict(
        device_capacity=1000.0, host_capacity=10_000.0,
        disk_capacity=100_000.0, host_link_bw=1e9, disk_bw=1e8,
        task_overhead=1e-6, alloc_cost=1e-6, staging_throttle=2000.0,
    )
    defaults.update(kw)
    return reference_hw(P, **defaults)


def fault_hw(P, **kw):
    """``tests/test_faults.py:small_hw`` (also ``test_obs.py``'s)."""
    defaults = dict(
        device_capacity=1e6, host_capacity=1e9, disk_capacity=1e12,
        host_link_bw=1e9, disk_bw=1e8, task_overhead=1e-6,
        alloc_cost=1e-6, staging_throttle=1e6,
    )
    defaults.update(kw)
    return reference_hw(P, **defaults)


def p100_with(P, **kw):
    return dataclasses.replace(P.core.HardwareModel.paper_p100(), **kw)


def stencil_plan(P, n=2048, chunk=256, devices=4):
    C = P.core
    planner = C.Planner(C.Topology(devices, devices_per_node=2))
    arrays = {
        "inp": C.ArrayMeta("inp", (n,), 4, C.BlockDist(chunk)),
        "out": C.ArrayMeta("out", (n,), 4, C.BlockDist(chunk)),
    }
    lp = planner.plan_launch("stencil", C.parse(STENCIL_TEXT), (n,),
                             C.EvenWork(), arrays)
    return lp, planner


def kmeans_arrays(P, n, chunk):
    C = P.core
    return {
        "points": C.ArrayMeta("points", (n,), 16, C.BlockDist(chunk)),
        "centroids": C.ArrayMeta("centroids", (40,), 16,
                                 C.ReplicatedDist()),
        "sums": C.ArrayMeta("sums", (40,), 16, C.ReplicatedDist()),
    }


def kmeans_plan(P, n, chunk, passes=1):
    """``tests/test_overlap_engine.py:kmeans_plan``."""
    C = P.core
    planner = C.Planner(C.Topology(1))
    plan = P.plan_ir.ExecutionPlan(launch_name="driver")
    arrays = kmeans_arrays(P, n, chunk)
    for _ in range(passes):
        planner.plan_launch("kmeans", C.parse(KMEANS_TEXT), (n,),
                            C.BlockWork(chunk), arrays, plan=plan)
    return plan


def kmeans_sim(P, plan, tracer=None, **kw):
    sim = P.core.Simulator(P.core.HardwareModel.paper_p100(), 1,
                           flops_per_thread=3000.0, bytes_per_thread=16.0,
                           tracer=tracer, **kw)
    return sim.run(plan)


def shared_input_plan(P, num_workers=4, num_blocks=4, nbytes=MB,
                      flops=10 ** 9):
    """``tests/test_d2d_fabric.py:shared_input_plan``."""
    I = P.plan_ir
    plan = I.ExecutionPlan(launch_name="shared_table")
    for w in range(num_workers):
        prev: list[int] = []
        for i in range(w + 1):
            t = plan.add(I.TaskKind.EXECUTE, w, deps=prev,
                         reads=[I.ChunkRef("priv", w * 16 + i)],
                         bytes=nbytes, flops=flops, label=f"warm{w}.{i}")
            prev = [t.tid]
        for b in range(num_blocks):
            t = plan.add(I.TaskKind.EXECUTE, w, deps=prev,
                         reads=[I.ChunkRef("table", b),
                                I.ChunkRef("priv", w * 16 + 8 + b)],
                         bytes=nbytes, flops=flops, label=f"use{w}.{b}")
            prev = [t.tid]
    return plan


def topo_hw(P, **kw):
    """paper_p100 with 2 workers a node (``hw_with_topology``)."""
    C = P.core
    return p100_with(P, topology=C.Interconnect(workers_per_node=2), **kw)


def fabric_run(P, plan, hw=None, workers=4, **kw):
    sim = P.core.Simulator(hw or P.core.HardwareModel.paper_p100(), workers,
                           flops_per_thread=1.0, **kw)
    return sim.run(plan)


def independent_tasks(P, num_tasks=4, worker=0, bytes_each=600,
                      flops=1000):
    I = P.plan_ir
    plan = I.ExecutionPlan(launch_name="throttle")
    for i in range(num_tasks):
        plan.add(I.TaskKind.EXECUTE, worker,
                 reads=[I.ChunkRef("x", i + 100 * worker)],
                 bytes=bytes_each, flops=flops, label=f"t{i}")
    return plan


# ---------------------------------------------------------------------------
# Memory manager (tests/test_simulator.py, test_overlap_engine.py,
# test_d2d_fabric.py, test_faults.py::TestOomDegradation)
# ---------------------------------------------------------------------------


def mm_stage_promotes(P):
    C = P.core
    mm = C.MemoryManager(small_hw(P))
    mm.register(("a", 0), 400)
    before = mm.tier_of(("a", 0)).name
    cost = mm.stage([("a", 0)])
    return {"before": before, "cost": cost, "tiers": tiers(mm),
            "stats": mm.stats}


def mm_lru_eviction(P):
    mm = P.core.MemoryManager(small_hw(P))
    for i in range(3):
        mm.register(("a", i), 400)
        mm.stage([("a", i)])
        mm.unstage([("a", i)])
    return {"tiers": tiers(mm), "stats": mm.stats,
            "used": {t.name: v for t, v in mm.used.items()}}


def mm_spill_cascades(P):
    """A device spill into a full host tier spills on to disk."""
    mm = P.core.MemoryManager(small_hw(P, host_capacity=500.0))
    for i in range(4):
        mm.register(("a", i), 400)
    mm.stage([("a", 0), ("a", 1)])
    mm.unstage([("a", 0), ("a", 1)])
    cost = mm.stage([("a", 2)])
    return {"cost": cost, "tiers": tiers(mm), "stats": mm.stats,
            "used": {t.name: v for t, v in mm.used.items()}}


def mm_pinned_never_evict(P):
    mm = P.core.MemoryManager(small_hw(P))
    mm.register(("a", 0), 600)
    mm.register(("a", 1), 600)
    mm.stage([("a", 0)])
    return {"raised": raised(lambda: mm.stage([("a", 1)])),
            "tiers": tiers(mm)}


def mm_working_set_too_big(P):
    mm = P.core.MemoryManager(small_hw(P))
    mm.register(("a", 0), 2000)
    return {"raised": raised(lambda: mm.stage([("a", 0)]))}


def mm_oracle_furthest(P):
    C = P.core
    mm = C.MemoryManager(p100_with(P, device_capacity=3000.0))
    for name in "abc":
        mm.register((name, 0), 1000, tier=C.Tier.DEVICE)
    mm.eviction_oracle = {("a", 0): None, ("b", 0): 50.0,
                          ("c", 0): 5.0}.get
    mm.register(("d", 0), 1000, tier=C.Tier.HOST)
    mm.stage([("d", 0)])
    return {"tiers": tiers(mm), "stats": mm.stats}


def mm_no_oracle_lru(P):
    C = P.core
    mm = C.MemoryManager(p100_with(P, device_capacity=2000.0))
    mm.register(("a", 0), 1000, tier=C.Tier.DEVICE)
    mm.register(("b", 0), 1000, tier=C.Tier.DEVICE)
    mm.touch(("a", 0))
    mm.register(("c", 0), 1000, tier=C.Tier.HOST)
    mm.stage([("c", 0)])
    return {"tiers": tiers(mm), "stats": mm.stats}


def _three_resident(P):
    mm = P.core.MemoryManager(p100_with(P, device_capacity=3.0 * MB),
                              registry=P.metrics.MetricsRegistry())
    keys = [("a", i) for i in range(3)]
    for k in keys:
        mm.register(k, MB)
    mm.stage(keys)
    mm.unstage(keys)
    return mm


def _stage_b(mm):
    mm.register(("b", 0), MB)
    mm.stage([("b", 0)])
    return {"tiers": tiers(mm), "stats": mm.stats}


def mm_peer_replicated_victim(P):
    mm = _three_resident(P)
    mm.peer_resident = lambda k: k == ("a", 1)
    return _stage_b(mm)


def mm_without_predicate(P):
    return _stage_b(_three_resident(P))


def mm_unknown_key_victim(P):
    mm = _three_resident(P)
    mm.eviction_oracle = {("a", 0): 5.0, ("a", 2): 9.0}.get
    return _stage_b(mm)


def mm_tie_breaks_lru(P):
    mm = _three_resident(P)
    mm.touch(("a", 0))
    mm.eviction_oracle = lambda k: 7.0
    return _stage_b(mm)


def mm_prefetch_and_receive(P):
    """``prefetch_one`` and ``receive_d2d`` directly: into free room,
    refused when full, and the demand form that evicts."""
    C = P.core
    mm = C.MemoryManager(small_hw(P))
    for i in range(4):
        mm.register(("a", i), 400)
    out = [mm.prefetch_one(("a", 0)), mm.prefetch_one(("a", 0)),
           mm.receive_d2d(("a", 1), evict=False),
           mm.receive_d2d(("a", 2), evict=False),
           mm.receive_d2d(("a", 2)), mm.prefetch_one(("zz", 9))]
    return {"out": out, "tiers": tiers(mm), "stats": mm.stats,
            "device_bytes": mm.device_bytes()}


def mm_degrade_spills(P):
    C = P.core
    mm = C.MemoryManager(fault_hw(P, device_capacity=1000.0))
    for i in range(2):
        mm.register(("a", i), 400)
        mm.stage([("a", i)])
        mm.unstage([("a", i)])
    used = mm.used[C.Tier.DEVICE]
    cost = mm.degrade()
    return {"used_before": used, "cost": cost,
            "capacity": mm.capacity[C.Tier.DEVICE],
            "used": mm.used[C.Tier.DEVICE], "stats": mm.stats,
            "tiers": tiers(mm)}


def mm_degrade_floors(P):
    C = P.core
    mm = C.MemoryManager(fault_hw(P, device_capacity=1000.0),
                         min_device_fraction=0.5)
    steps = [mm.degrade() for _ in range(4)]
    return {"steps": steps, "capacity": mm.capacity[C.Tier.DEVICE]}


def mm_degrade_keeps_pinned(P):
    mm = P.core.MemoryManager(fault_hw(P, device_capacity=1000.0))
    mm.register(("a", 0), 900)
    mm.stage([("a", 0)])
    return {"cost": mm.degrade(), "tiers": tiers(mm)}


def mm_occupancy_gauges(P):
    C = P.core
    reg = P.metrics.MetricsRegistry()
    mm = C.MemoryManager(fault_hw(P), worker=0, registry=reg)
    mm.register(("a", 0), 1000, C.Tier.HOST)
    mm.stage([("a", 0)])
    return {"snapshot": reg.snapshot(), "stats": mm.stats}


# ---------------------------------------------------------------------------
# Simulator (tests/test_simulator.py)
# ---------------------------------------------------------------------------


def sim_completes(P):
    lp, _ = stencil_plan(P)
    sim = P.core.Simulator(small_hw(P, device_capacity=1e6,
                                    staging_throttle=1e6),
                           4, flops_per_thread=10.0)
    return result(sim.run(lp.plan))


def sim_more_devices(P):
    C = P.core
    hw = small_hw(P, device_capacity=1e9, host_capacity=1e12)
    n = 1 << 20
    out = {}
    for devices in (1, 4):
        planner = C.Planner(C.Topology(devices, devices_per_node=4))
        arrays = {
            "inp": C.ArrayMeta("inp", (n,), 4, C.BlockDist(n // devices)),
            "out": C.ArrayMeta("out", (n,), 4, C.BlockDist(n // devices)),
        }
        lp = planner.plan_launch("map", C.parse(MAP_TEXT), (n,),
                                 C.EvenWork(), arrays)
        out[devices] = result(C.Simulator(hw, devices,
                                          flops_per_thread=1000.0)
                              .run(lp.plan))
    return out


def _chunk_tradeoff(P, chunk):
    C = P.core
    hw = small_hw(P, device_capacity=2e8, host_capacity=1e12,
                  host_link_bw=16e9, task_overhead=5e-5,
                  staging_throttle=1e8)
    n = 1 << 22
    planner = C.Planner(C.Topology(1))
    arrays = {
        "inp": C.ArrayMeta("inp", (n,), 4, C.BlockDist(chunk)),
        "out": C.ArrayMeta("out", (n,), 4, C.BlockDist(chunk)),
    }
    lp = planner.plan_launch("map", C.parse(MAP_TEXT), (n,),
                             C.BlockWork(chunk), arrays)
    return result(C.Simulator(hw, 1, flops_per_thread=200.0,
                              bytes_per_thread=8.0).run(lp.plan))


def throttle_stage_wait(P):
    sim = P.core.Simulator(small_hw(P, device_capacity=1e5,
                                    staging_throttle=1000.0), 1)
    res = sim.run(independent_tasks(P))
    return {"result": result(res), "throttled_since": sim.throttled_since}


def throttle_ample(P):
    sim = P.core.Simulator(small_hw(P, device_capacity=1e5,
                                    staging_throttle=1e6), 1)
    return result(sim.run(independent_tasks(P)))


def throttle_worker_death(P):
    C = P.core
    inj = C.FaultInjector([C.kill_worker(worker=1, after=1)], seed=3)
    sim = C.Simulator(small_hw(P, device_capacity=1e5,
                               staging_throttle=1000.0), 2,
                      fault_injector=inj,
                      recovery=C.RecoveryPolicy(max_attempts=8), seed=3)
    res = sim.run(independent_tasks(P, num_tasks=4, worker=1))
    return {"result": result(res), "throttled_since": sim.throttled_since,
            "worker_map": dict(sim.worker_map)}


def utilization_normalized(P):
    res = P.scheduler.SimResult(makespan=2.0, busy={"compute": 3.0},
                                task_count=4, stats={}, num_workers=2)
    zero = P.scheduler.SimResult(makespan=0.0, busy={}, task_count=0,
                                 stats={})
    return {"two": res.utilization("compute"), "zero": zero.utilization()}


def utilization_four_workers(P):
    C = P.core
    planner = C.Planner(C.Topology(4, devices_per_node=2))
    arrays = {
        "inp": C.ArrayMeta("inp", (4096,), 4, C.BlockDist(1024)),
        "out": C.ArrayMeta("out", (4096,), 4, C.BlockDist(1024)),
    }
    lp = planner.plan_launch("k", C.parse(MAP_TEXT), (4096,), C.EvenWork(),
                             arrays)
    res = C.Simulator(C.HardwareModel.paper_p100(), 4,
                      flops_per_thread=1000.0).run(lp.plan)
    return {"result": result(res),
            "compute": res.utilization("compute")}


# ---------------------------------------------------------------------------
# Overlap engine (tests/test_overlap_engine.py)
# ---------------------------------------------------------------------------


def _prefetch_sweep(P, chunk):
    n = 1 << 22
    tr_b, tr_p = P.trace.Tracer(), P.trace.Tracer()
    base = kmeans_sim(P, kmeans_plan(P, n, chunk), tracer=tr_b)
    pf = kmeans_sim(P, kmeans_plan(P, n, chunk), tracer=tr_p,
                    prefetch_window=8)
    return {"base": result(base), "prefetch": result(pf),
            "overlap_base": P.overlap.analyze(tr_b).to_dict(),
            "overlap_prefetch": P.overlap.analyze(tr_p).to_dict(),
            "trace_prefetch": tr_p.to_json()}


def prefetch_off_by_default(P):
    n, chunk = 1 << 20, 1 << 17
    tr_default, tr_off = P.trace.Tracer(), P.trace.Tracer()
    kmeans_sim(P, kmeans_plan(P, n, chunk), tracer=tr_default)
    kmeans_sim(P, kmeans_plan(P, n, chunk), tracer=tr_off,
               prefetch_window=0, eviction="lru")
    return {"default": tr_default.to_json(), "off": tr_off.to_json()}


def prefetch_counters(P):
    return result(kmeans_sim(P, kmeans_plan(P, 1 << 22, 1 << 17),
                             prefetch_window=8))


def prefetch_keys_present(P):
    return result(kmeans_sim(P, kmeans_plan(P, 1 << 18, 1 << 16)))


def bad_eviction_policy(P):
    return {"raised": raised(lambda: P.core.Simulator(
        P.core.HardwareModel.paper_p100(), 1, eviction="mru"))}


def belady_vs_lru(P):
    hw = p100_with(P, device_capacity=4.5e6, staging_throttle=3.3e6)
    plan = kmeans_plan(P, 1 << 20, 1 << 17, passes=3)
    out = {}
    for policy in ("lru", "belady"):
        sim = P.core.Simulator(hw, 1, flops_per_thread=3000.0,
                               bytes_per_thread=16.0, eviction=policy)
        out[policy] = result(sim.run(plan))
    return out


# ---------------------------------------------------------------------------
# d2d fabric (tests/test_d2d_fabric.py)
# ---------------------------------------------------------------------------


def interconnect_model(P):
    ic = P.core.Interconnect(workers_per_node=2)
    return {
        "nodes": [ic.node(w) for w in range(4)],
        "same": [ic.same_node(0, 1), ic.same_node(1, 2)],
        "links": [ic.link(0, 1), ic.link(0, 2)],
        "times": [ic.transfer_time(MB, 0, 1), ic.transfer_time(MB, 0, 2)],
        "cheapest": [ic.cheapest_source(3, [0, 1, 2]),
                     ic.cheapest_source(3, [0, 1]),
                     ic.cheapest_source(0, [1, 2, 3])],
    }


def paper_presets(P):
    C = P.core
    hw = C.HardwareModel.paper_cluster()
    return {"p100": dataclasses.asdict(C.HardwareModel.paper_p100()),
            "cluster": dataclasses.asdict(hw),
            "interconnect": dataclasses.asdict(C.Interconnect.paper_cluster()),
            "cluster_is_p100": dataclasses.replace(hw, topology=None)
            == C.HardwareModel.paper_p100()}


def d2d_host_vs_fabric(P):
    return {"host": result(fabric_run(P, shared_input_plan(P))),
            "fabric": result(fabric_run(P, shared_input_plan(P),
                                        hw=topo_hw(P)))}


def d2d_multicast_off(P):
    return result(fabric_run(P, shared_input_plan(P), hw=topo_hw(P),
                             multicast=False))


def d2d_trace(P):
    tr = P.trace.Tracer()
    res = fabric_run(P, shared_input_plan(P), hw=topo_hw(P), tracer=tr)
    return {"result": result(res), "trace": tr.to_json(),
            "overlap": P.overlap.analyze(tr).to_dict()}


def no_topology_traces(P):
    out = {}
    for name, kw in (("default", {}), ("no_multicast", {"multicast": False}),
                     ("pf", {"prefetch_window": 4}),
                     ("pf_no_multicast", {"prefetch_window": 4,
                                          "multicast": False})):
        tr = P.trace.Tracer()
        fabric_run(P, shared_input_plan(P), tracer=tr, **kw)
        out[name] = tr.to_json()
    return out


def prefetch_rides_d2d(P):
    tr = P.trace.Tracer()
    res = fabric_run(P, shared_input_plan(P), hw=topo_hw(P), tracer=tr,
                     prefetch_window=8, multicast=False)
    return {"result": result(res), "trace": tr.to_json()}


def prefetch_skip_and_continue(P):
    I = P.plan_ir
    plan = I.ExecutionPlan(launch_name="blocked_chain")
    t0 = plan.add(I.TaskKind.EXECUTE, 1, writes=[I.ChunkRef("p", 0)],
                  bytes=MB, flops=10 ** 9, label="producer")
    for i in range(4):
        plan.add(I.TaskKind.EXECUTE, 0, deps=[t0.tid],
                 reads=[I.ChunkRef("p", 0)], bytes=MB, flops=10 ** 9,
                 label=f"consumer{i}")
    for j in range(4):
        plan.add(I.TaskKind.EXECUTE, 0, deps=[t0.tid],
                 reads=[I.ChunkRef("in", j)], bytes=MB, flops=10 ** 9,
                 label=f"tail{j}")
    return result(fabric_run(P, plan, workers=2, prefetch_window=2))


def prefetch_nothing_blocked(P):
    I = P.plan_ir
    plan = I.ExecutionPlan(launch_name="flat")
    for j in range(6):
        plan.add(I.TaskKind.EXECUTE, 0, reads=[I.ChunkRef("in", j)],
                 bytes=MB, flops=10 ** 9, label=f"t{j}")
    return result(fabric_run(P, plan, workers=1, prefetch_window=3))


def peer_evictions_under_pressure(P):
    hw = topo_hw(P, device_capacity=3.0 * MB, staging_throttle=2.5 * MB)
    return result(fabric_run(P, shared_input_plan(P), hw=hw))


def belady_death_with_d2d(P):
    C = P.core
    hw = topo_hw(P, device_capacity=6.0 * MB, staging_throttle=4.0 * MB)
    inj = C.FaultInjector([C.kill_worker(worker=3, after=2)], seed=7)
    res = fabric_run(P, shared_input_plan(P), hw=hw, fault_injector=inj,
                     recovery=C.RecoveryPolicy(max_attempts=8), seed=7,
                     eviction="belady")
    return result(res)


def dead_worker_never_sources(P):
    C = P.core
    tr = P.trace.Tracer()
    inj = C.FaultInjector([C.kill_worker(worker=3, after=2)], seed=7)
    res = fabric_run(P, shared_input_plan(P), hw=topo_hw(P), tracer=tr,
                     fault_injector=inj,
                     recovery=C.RecoveryPolicy(max_attempts=8), seed=7)
    return {"result": result(res), "trace": tr.to_json()}


# ---------------------------------------------------------------------------
# Recovery engine (tests/test_faults.py::TestSimulatorRecovery), by seed
# ---------------------------------------------------------------------------


def chaos_worker_death(P, seed):
    C = P.core
    lp, planner = stencil_plan(P)
    inj = C.FaultInjector([
        C.kill_worker(worker=1, after=2), C.fail_task(at=3),
        C.fail_task(at=7), C.timeout_transfer(at=0),
        C.corrupt_transfer(at=1),
    ], seed=seed)
    sim = C.Simulator(fault_hw(P), 4, flops_per_thread=10.0,
                      fault_injector=inj,
                      recovery=C.RecoveryPolicy(max_attempts=8),
                      chunk_state=planner.chunk_state, seed=seed)
    res = sim.run(lp.plan)
    return {"result": result(res), "events": _events(inj),
            "replayed": sorted(sim.replayed_keys),
            "worker_map": dict(sim.worker_map)}


def _events(inj):
    return [dataclasses.astuple(e) for e in inj.events]


def lineage_replay(P, seed):
    C = P.core
    devices, n = 4, 1024
    planner = C.Planner(C.Topology(devices, devices_per_node=2))
    plan = P.plan_ir.ExecutionPlan(launch_name="chain")
    arrays1 = {
        "a": C.ArrayMeta("a", (n,), 4, C.BlockDist(n // devices)),
        "b": C.ArrayMeta("b", (n,), 4, C.BlockDist(n // devices)),
    }
    planner.plan_launch("produce", C.parse("global i => read a[i], "
                                           "write b[i]"),
                        (n,), C.EvenWork(), arrays1, plan=plan)
    arrays2 = {"b": arrays1["b"],
               "c": C.ArrayMeta("c", (n,), 4, C.BlockDist(n // devices))}
    planner.plan_launch("consume", C.parse("global i => read b[i], "
                                           "write c[i]"),
                        (n,), C.EvenWork(), arrays2, plan=plan)
    inj = C.FaultInjector([C.kill_worker(worker=1, after=0)], seed=seed)
    sim = C.Simulator(fault_hw(P), devices, flops_per_thread=10.0,
                      fault_injector=inj,
                      recovery=C.RecoveryPolicy(max_attempts=8),
                      chunk_state=planner.chunk_state, seed=seed)
    res = sim.run(plan)
    return {"result": result(res), "replayed": sorted(sim.replayed_keys),
            "events": _events(inj)}


def replay_homes_all_consumers(P, seed):
    C, I = P.core, P.plan_ir
    plan = I.ExecutionPlan(launch_name="fanout")
    t0 = plan.add(I.TaskKind.EXECUTE, 1, writes=[I.ChunkRef("a", 0)],
                  bytes=1000, flops=100, label="produce")
    f2 = plan.add(I.TaskKind.EXECUTE, 2, flops=5000, label="filler2")
    f3 = plan.add(I.TaskKind.EXECUTE, 3, flops=5000, label="filler3")
    plan.add(I.TaskKind.EXECUTE, 2, deps=[t0.tid, f2.tid],
             reads=[I.ChunkRef("a", 0)], bytes=1000, flops=100,
             label="consume2")
    plan.add(I.TaskKind.EXECUTE, 3, deps=[t0.tid, f3.tid],
             reads=[I.ChunkRef("a", 0)], bytes=1000, flops=100,
             label="consume3")
    inj = C.FaultInjector([C.kill_worker(worker=1, after=0)], seed=seed)
    sim = C.Simulator(fault_hw(P), 4, flops_per_thread=10.0,
                      fault_injector=inj,
                      recovery=C.RecoveryPolicy(max_attempts=8), seed=seed)
    sim.memory[1].register(("a", 0), 1000, tier=C.Tier.HOST)
    res = sim.run(plan, register_chunks=False)
    return {"result": result(res), "replayed": sorted(sim.replayed_keys),
            "homes": [("a", 0) in m.chunks for m in sim.memory]}


def spurious_oom(P, seed):
    C = P.core
    lp, _ = stencil_plan(P)
    inj = C.FaultInjector([C.spurious_oom(at=2)], seed=seed)
    sim = C.Simulator(fault_hw(P), 4, flops_per_thread=10.0,
                      fault_injector=inj, seed=seed)
    return {"result": result(sim.run(lp.plan)), "events": _events(inj)}


def bounded_schedules(P, seed):
    """``test_any_bounded_fault_schedule_recovers`` on three schedules
    drawn from ``seed`` (up to five faults and one worker death)."""
    C = P.core
    ctor = {"task": C.fail_task, "transfer_timeout": C.timeout_transfer,
            "transfer_corrupt": C.corrupt_transfer, "oom": C.spurious_oom}
    draw = random.Random(seed)
    out = []
    for _ in range(3):
        specs = [ctor[draw.choice(sorted(ctor))](at=draw.randint(0, 25))
                 for _ in range(draw.randint(0, 5))]
        if draw.random() < 0.5:
            specs.append(C.kill_worker(worker=draw.randint(0, 3),
                                       after=draw.randint(0, 4)))
        lp, planner = stencil_plan(P)
        inj = C.FaultInjector(specs, seed=seed)
        sim = C.Simulator(fault_hw(P), 4, flops_per_thread=10.0,
                          fault_injector=inj,
                          recovery=C.RecoveryPolicy(max_attempts=10),
                          chunk_state=planner.chunk_state, seed=seed)
        out.append({"result": result(sim.run(lp.plan)),
                    "events": _events(inj)})
    return out


def fault_metrics(P, seed):
    C = P.core
    lp, _ = stencil_plan(P)
    reg = P.metrics.MetricsRegistry()
    inj = C.FaultInjector([
        C.fail_task(probability=0.1, times=0),
        C.timeout_transfer(probability=0.05, times=0),
        C.kill_worker(worker=1, after=1),
    ], seed=seed, registry=reg)
    res = C.Simulator(fault_hw(P), 4, fault_injector=inj,
                      registry=reg).run(lp.plan)
    return {"result": result(res), "snapshot": reg.snapshot(),
            "events": _events(inj)}


def genuine_oom(P):
    C = P.core
    planner = C.Planner(C.Topology(1))
    arrays = {
        "inp": C.ArrayMeta("inp", (1000,), 4, C.BlockDist(1000)),
        "out": C.ArrayMeta("out", (1000,), 4, C.BlockDist(1000)),
    }
    lp = planner.plan_launch("map", C.parse(MAP_TEXT), (1000,),
                             C.EvenWork(), arrays)
    sim = C.Simulator(fault_hw(P, device_capacity=1000.0), 1,
                      fault_injector=C.FaultInjector(),
                      recovery=C.RecoveryPolicy(max_attempts=2))
    return {"raised": raised(lambda: sim.run(lp.plan)),
            "capacity": sim.memory[0].capacity[C.Tier.DEVICE],
            "stats": sim.memory[0].stats}


#: scenario name -> function(P); the seeded ones are in SEEDED
SCENARIOS = {
    "mm_stage_promotes": mm_stage_promotes,
    "mm_lru_eviction": mm_lru_eviction,
    "mm_spill_cascades": mm_spill_cascades,
    "mm_pinned_never_evict": mm_pinned_never_evict,
    "mm_working_set_too_big": mm_working_set_too_big,
    "mm_oracle_furthest": mm_oracle_furthest,
    "mm_no_oracle_lru": mm_no_oracle_lru,
    "mm_peer_replicated_victim": mm_peer_replicated_victim,
    "mm_without_predicate": mm_without_predicate,
    "mm_unknown_key_victim": mm_unknown_key_victim,
    "mm_tie_breaks_lru": mm_tie_breaks_lru,
    "mm_prefetch_and_receive": mm_prefetch_and_receive,
    "mm_degrade_spills": mm_degrade_spills,
    "mm_degrade_floors": mm_degrade_floors,
    "mm_degrade_keeps_pinned": mm_degrade_keeps_pinned,
    "mm_occupancy_gauges": mm_occupancy_gauges,
    "sim_completes": sim_completes,
    "sim_more_devices": sim_more_devices,
    "chunk_tiny": lambda P: _chunk_tradeoff(P, 1 << 12),
    "chunk_mid": lambda P: _chunk_tradeoff(P, 1 << 18),
    "chunk_huge": lambda P: _chunk_tradeoff(P, 1 << 22),
    "throttle_stage_wait": throttle_stage_wait,
    "throttle_ample": throttle_ample,
    "throttle_worker_death": throttle_worker_death,
    "utilization_normalized": utilization_normalized,
    "utilization_four_workers": utilization_four_workers,
    "prefetch_off_by_default": prefetch_off_by_default,
    "prefetch_counters": prefetch_counters,
    "prefetch_keys_present": prefetch_keys_present,
    "bad_eviction_policy": bad_eviction_policy,
    "belady_vs_lru": belady_vs_lru,
    "interconnect_model": interconnect_model,
    "paper_presets": paper_presets,
    "d2d_host_vs_fabric": d2d_host_vs_fabric,
    "d2d_multicast_off": d2d_multicast_off,
    "d2d_trace": d2d_trace,
    "no_topology_traces": no_topology_traces,
    "prefetch_rides_d2d": prefetch_rides_d2d,
    "prefetch_skip_and_continue": prefetch_skip_and_continue,
    "prefetch_nothing_blocked": prefetch_nothing_blocked,
    "peer_evictions_under_pressure": peer_evictions_under_pressure,
    "belady_death_with_d2d": belady_death_with_d2d,
    "dead_worker_never_sources": dead_worker_never_sources,
    "genuine_oom": genuine_oom,
}
for _chunk in (1 << 13, 1 << 15, 1 << 17, 1 << 19, 1 << 21):
    SCENARIOS[f"prefetch_sweep_{_chunk}"] = (
        lambda P, c=_chunk: _prefetch_sweep(P, c))

@functools.lru_cache(maxsize=None)
def run(name: str, root: str, *args):
    """Scenario ``name`` (of :data:`SCENARIOS` or :data:`SEEDED`) on package
    ``root``, run once a process: the parity test and the claims test read
    the same answer."""
    fn = SCENARIOS.get(name) or SEEDED[name]
    return fn(package(root), *args)


#: scenarios of the recovery engine, run at each chaos seed
SEEDED = {
    "chaos_worker_death": chaos_worker_death,
    "lineage_replay": lineage_replay,
    "replay_homes_all_consumers": replay_homes_all_consumers,
    "spurious_oom": spurious_oom,
    "bounded_schedules": bounded_schedules,
    "fault_metrics": fault_metrics,
}
CHAOS_SEEDS = (1, 7, 1234)


# ---------------------------------------------------------------------------
# benchmarks/bench_sim.py:collect() on either package
# ---------------------------------------------------------------------------


def fig10_run_one(P, n_records, chunk, prefetch_window=0):
    """``benchmarks/paper_fig10_chunksize.py:run_one`` on the paper's P100
    model, traced, as ``bench_sim`` calls it."""
    C = P.core
    tracer = P.trace.Tracer()
    planner = C.Planner(C.Topology(1))
    lp = planner.plan_launch("kmeans", C.parse(KMEANS_TEXT), (n_records,),
                             C.BlockWork(chunk),
                             kmeans_arrays(P, n_records, chunk))
    res = kmeans_sim(P, lp.plan, tracer=tracer,
                     prefetch_window=prefetch_window)
    return {
        "makespan_s": res.makespan,
        "prefetch_issued": res.stats.get("prefetch_issued", 0),
        "prefetch_hits": res.stats.get("prefetch_hits", 0),
        "overlap_fraction": P.overlap.analyze(tracer).overlap_fraction,
    }


def bench_fig10(P):
    out = []
    for chunk in (1 << 13, 1 << 15, 1 << 17, 1 << 19, 1 << 21):
        base = fig10_run_one(P, 1 << 22, chunk)
        pf = fig10_run_one(P, 1 << 22, chunk, prefetch_window=8)
        out.append({
            "chunk_bytes": chunk * 16,
            "baseline": {"makespan_s": base["makespan_s"],
                         "overlap_fraction": base["overlap_fraction"]},
            "prefetch": {"makespan_s": pf["makespan_s"],
                         "overlap_fraction": pf["overlap_fraction"],
                         "prefetch_issued": pf["prefetch_issued"],
                         "prefetch_hits": pf["prefetch_hits"]},
        })
    return out


def bench_eviction(P):
    C = P.core
    n, chunk = 1 << 20, 1 << 17
    hw = p100_with(P, device_capacity=4.5e6, staging_throttle=3.3e6)
    out = {}
    for policy in ("lru", "belady"):
        res = C.Simulator(hw, 1, flops_per_thread=3000.0,
                          bytes_per_thread=16.0, eviction=policy).run(
            kmeans_plan(P, n, chunk, passes=3))
        out[policy] = {
            "makespan_s": res.makespan,
            "evictions": res.stats.get("evictions", 0),
            "oracle_evictions": res.stats.get("oracle_evictions", 0),
            "h2d_bytes": res.stats.get("h2d_bytes", 0),
        }
    return out


def bench_plan_cache(P, steps=20):
    C = P.core
    update = C.parse("global i => read sums[:], write centroids[i]")
    kmeans = C.parse(KMEANS_TEXT)
    n, chunk = 1 << 16, 1 << 13
    reg = P.metrics.MetricsRegistry()
    planner = C.Planner(C.Topology(4, devices_per_node=2), registry=reg)
    plan = P.plan_ir.ExecutionPlan(launch_name="driver")
    arrays = kmeans_arrays(P, n, chunk)
    for _ in range(steps):
        planner.plan_launch("assign", kmeans, (n,), C.BlockWork(chunk),
                            arrays, plan=plan)
        planner.plan_launch("update", update, (40,), C.BlockWork(10),
                            arrays, plan=plan)
    snap = reg.snapshot()
    hits = snap.get("plan.cache{result=hit}", 0.0)
    misses = snap.get("plan.cache{result=miss}", 0.0)
    uncacheable = snap.get("plan.cache{result=uncacheable}", 0.0)
    lookups = hits + misses + uncacheable
    return {"launches": 2 * steps, "hits": hits, "misses": misses,
            "uncacheable": uncacheable,
            "hit_rate": hits / lookups if lookups else 0.0,
            "plan_tasks": len(plan.tasks)}


def bench_recovery(P):
    C = P.core
    lp, planner = stencil_plan(P)
    hw = p100_with(P, device_capacity=1e6, staging_throttle=1e6)
    inj = C.FaultInjector([C.kill_worker(worker=1, after=2)], seed=7)
    sim = C.Simulator(hw, 4, flops_per_thread=10.0, fault_injector=inj,
                      recovery=C.RecoveryPolicy(max_attempts=8),
                      chunk_state=planner.chunk_state, seed=7)
    res = sim.run(lp.plan)
    keys = ("worker_deaths", "lineage_replays", "recovered_tasks",
            "tasks_rescheduled", "replica_recoveries")
    out = {k: res.stats.get(k, 0) for k in keys}
    out["makespan_s"] = res.makespan
    out["task_count"] = res.task_count
    return out


def bench_d2d(P):
    C = P.core
    hw_host = C.HardwareModel.paper_p100()
    hw_d2d = dataclasses.replace(
        hw_host, topology=C.Interconnect(workers_per_node=2))
    out: dict = {}
    for name, hw in (("host_only", hw_host), ("d2d", hw_d2d)):
        res = fabric_run(P, shared_input_plan(P), hw=hw)
        out[name] = {
            "makespan_s": res.makespan,
            "h2d_bytes": res.stats.get("h2d_bytes", 0),
            "d2d_bytes": res.stats.get("d2d_bytes", 0),
            "d2d_transfers": res.stats.get("d2d_transfers", 0),
            "multicast_fanout": res.stats.get("multicast_fanout", 0),
        }
    n, nw = 1 << 16, 4
    arrays = {
        "inp": C.ArrayMeta("inp", (n,), 4, C.RowDist(num_chunks=nw)),
        "out": C.ArrayMeta("out", (n,), 4, C.RowDist(num_chunks=nw)),
    }
    placement: dict = {}
    for mode in ("owner", "locality"):
        reg = P.metrics.MetricsRegistry()
        planner = C.Planner(C.Topology(nw, devices_per_node=2),
                            registry=reg, placement=mode)
        lp = planner.plan_launch("axpy", C.parse(MAP_TEXT), (n,),
                                 C.BlockWork(n // 8), arrays)
        placement[f"{mode}_comm_bytes"] = lp.total_comm_bytes()
    placement["affinity_hits"] = reg.snapshot().get(
        "place.affinity_hits", 0.0)
    out["placement"] = placement
    return out


#: ``BENCH_sim.json``'s sections and the functions that make them
BENCH_SECTIONS = {
    "fig10": bench_fig10,
    "eviction": bench_eviction,
    "plan_cache": bench_plan_cache,
    "recovery": bench_recovery,
    "d2d": bench_d2d,
}

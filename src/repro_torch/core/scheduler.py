"""Per-worker asynchronous scheduler — discrete-event simulator (paper §3.3).

The paper's workers each run a scheduler that (1) waits for task
dependencies, (2) stages the task's chunks through the memory manager,
(3) queues the task on the right executor (GPU / copy engine / network), and
(4) unstages on completion.  Staging is throttled by total in-flight memory
footprint (~2 GB) to balance prefetch depth against contention.

This module reproduces that pipeline as a discrete-event simulation over an
:class:`~repro_torch.core.plan_ir.ExecutionPlan`, with task durations from
the :class:`~repro_torch.core.memory.HardwareModel`.  It exists to (a)
reproduce the paper's chunk-size / spilling figures on a CPU, and (b)
predict what a schedule should take on the card before the launch path is
changed (``chip_smoke.py``'s ``sim`` phase sets its prediction for the
streamed K-Means beside the measured one).

Executors per worker (all overlap, like CUDA streams and copy engines):
  * ``compute``  — kernel execution          (duration = flops / peak)
  * ``h2d``      — staging transfers          (duration from MemoryManager)
  * ``copy``     — intra-node chunk copies    (bytes / ici_bw)
  * ``net``      — inter-node send/recv       (bytes / net_bw)

Fault tolerance: with a :class:`~repro_torch.core.faults.FaultInjector`
threaded in, the simulator exercises a full **recovery engine** instead of
treating any failure as fatal:

* failed tasks / timed-out / corrupted transfers retry with capped
  exponential backoff (:class:`~repro_torch.core.faults.RecoveryPolicy`);
* :class:`~repro_torch.core.memory.OutOfMemory` during staging retries and,
  when repeated, triggers graceful tier demotion (``MemoryManager.degrade``);
* a dead worker's pending tasks re-plan onto the survivors via the
  ``StragglerMonitor.backup_assignment`` path from
  :mod:`repro_torch.dist.fault`, and chunks lost with it are recovered from
  surviving replicas or recomputed from their lineage (the plan's producer
  tasks — paper §3.2's dependency edges put to work).

Every recovery action is surfaced in ``SimResult.stats`` so benchmarks can
report makespan-under-faults next to the fault-free figures.

Observability: all counters live on a
:class:`~repro_torch.obs.metrics.MetricsRegistry` (``sim.*`` for scheduler
counters, ``mem.*`` for the per-worker memory managers' labeled children —
the registry's parent aggregation replaces a hand-summed per-manager
merge).  ``SimResult.stats`` remains a plain dict compatibility view,
computed as the per-run registry delta.  With a
:class:`~repro_torch.obs.trace.Tracer` threaded in, every staging transfer,
task execution, lineage replay, and recovery action lands on a
per-worker/per-stream timeline exportable to Perfetto; with the default
:data:`~repro_torch.obs.trace.NULL_TRACER` no span objects are allocated at
all.
"""

from __future__ import annotations

import dataclasses
import heapq
import random
from typing import Callable

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import NULL_TRACER

from .faults import FaultInjector, RecoveryPolicy
from .memory import MEM_STAT_KEYS, HardwareModel, MemoryManager, \
    OutOfMemory, Tier
from .plan_ir import ExecutionPlan, Task, TaskKind

#: SimResult.stats keys the recovery engine maintains (always present, zero
#: when nothing fired — benchmarks can report them unconditionally).
RECOVERY_STAT_KEYS = (
    "faults_injected", "task_retries", "transfer_retries", "oom_events",
    "oom_degradations", "worker_deaths", "tasks_rescheduled",
    "replica_recoveries", "lineage_replays", "recovered_tasks",
)

#: Counters the overlap engine's lookahead prefetcher maintains (always
#: present, zero when prefetching is off).
PREFETCH_STAT_KEYS = (
    "prefetch_issued", "prefetch_bytes", "prefetch_hits", "prefetch_wasted",
    "prefetch_skipped",
)

#: How many upcoming tasks the prefetcher may scan past producer-blocked
#: entries per round, as a multiple of the window (bounds per-call cost of
#: the skip-and-continue scan across superblock boundaries).
_PF_SCAN_FACTOR = 8

#: ``SimResult.stats`` keys the d2d transfer fabric maintains (always
#: present, zero with no topology configured).  They mirror the registry
#: counters ``d2d.bytes``, ``d2d.transfers``, and ``multicast.fanout``.
D2D_STAT_KEYS = ("d2d_bytes", "d2d_transfers", "multicast_fanout")

#: Scheduler-owned registry counters (``sim.<key>``).
_SIM_STAT_KEYS = ("stage_wait",) + PREFETCH_STAT_KEYS + RECOVERY_STAT_KEYS


@dataclasses.dataclass
class SimResult:
    makespan: float
    busy: dict[str, float]  # resource -> busy seconds (summed over workers)
    task_count: int
    stats: dict[str, float]
    num_workers: int = 1

    def utilization(self, resource: str = "compute") -> float:
        """Fraction of the makespan this resource was busy, averaged over
        workers (``busy`` sums across workers, so the denominator must
        scale with worker count or utilization could exceed 1.0)."""
        denom = self.makespan * max(1, self.num_workers)
        return self.busy.get(resource, 0.0) / denom if self.makespan else 0.0

    def recovery_stats(self) -> dict[str, float]:
        return {k: self.stats.get(k, 0.0) for k in RECOVERY_STAT_KEYS}


_EXECUTOR_FOR = {
    TaskKind.EXECUTE: "compute",
    TaskKind.COPY: "copy",
    TaskKind.SEND: "net",
    TaskKind.RECV: "net",
    TaskKind.REDUCE: "compute",
    TaskKind.CREATE_CHUNK: "h2d",
    TaskKind.DELETE_CHUNK: "h2d",
    TaskKind.SYNC_REPLICAS: "copy",
}

_TRANSFER_KINDS = (TaskKind.COPY, TaskKind.SEND, TaskKind.RECV,
                   TaskKind.SYNC_REPLICAS)

#: Trace category per executor stream (the overlap analyzer's grouping).
#: ``d2d`` is the peer-to-peer staging stream added with the transfer
#: fabric — its spans count as transfers like h2d/copy/net.
_CAT_FOR_RESOURCE = {
    "compute": "compute", "h2d": "transfer", "copy": "transfer",
    "net": "transfer", "d2d": "transfer",
}


class Simulator:
    """Event-driven execution of a task DAG against the hardware model."""

    def __init__(
        self,
        hw: HardwareModel,
        num_workers: int,
        flops_per_thread: float = 1.0,
        bytes_per_thread: float = 0.0,
        duration_fn: Callable[[Task], float] | None = None,
        initial_tier: Tier = Tier.HOST,
        fault_injector: FaultInjector | None = None,
        recovery: RecoveryPolicy | None = None,
        chunk_state=None,  # planner ChunkStateTable, for lineage lookups
        seed: int = 0,
        tracer=None,
        registry: MetricsRegistry | None = None,
        prefetch_window: int = 0,
        eviction: str = "lru",
        multicast: bool = True,
    ):
        if eviction not in ("lru", "belady"):
            raise ValueError(f"unknown eviction policy {eviction!r}")
        self.hw = hw
        # d2d transfer fabric: with ``hw.topology`` set, a chunk that is
        # DEVICE-resident on a peer worker stages peer-to-peer over the
        # cheapest link (its own ``d2d`` stream) instead of from HOST, and
        # ``multicast`` (on by default, only active with a topology) chains
        # a freshly host-staged chunk to every other worker that will
        # consume it.  With ``hw.topology=None`` nothing changes.
        self.multicast = bool(multicast)
        # Overlap engine (paper §3.3): with ``prefetch_window`` > 0 each
        # worker looks that many upcoming tasks ahead and issues their
        # chunk transfers on the h2d stream while compute runs, bounded by
        # ``hw.staging_throttle``.  The default (0) keeps the original
        # demand-staging schedule byte-identical.  ``eviction="belady"``
        # installs a next-use oracle derived from the plan's task order so
        # the memory manager evicts the chunk used furthest in the future.
        self.prefetch_window = int(prefetch_window)
        self.eviction = eviction
        self.num_workers = num_workers
        self.flops_per_thread = flops_per_thread
        self.bytes_per_thread = bytes_per_thread
        self.duration_fn = duration_fn
        self.initial_tier = initial_tier
        self.fault_injector = fault_injector
        self.recovery = recovery or RecoveryPolicy()
        self.chunk_state = chunk_state
        self.seed = seed
        self.tracer = tracer or NULL_TRACER
        # One registry shared with every worker's memory manager: per-worker
        # counters are labeled children, so cross-worker totals come from
        # the parents instead of a hand-summed merge at the end of run().
        self.registry = registry or MetricsRegistry()
        self.memory = [
            MemoryManager(hw, injector=fault_injector, worker=i,
                          registry=self.registry, tracer=self.tracer)
            for i in range(num_workers)
        ]

    # -- cost model ---------------------------------------------------------------

    def _duration(self, t: Task) -> float:
        if self.duration_fn is not None:
            d = self.duration_fn(t)
            if d is not None:
                return d
        hw = self.hw
        if t.kind is TaskKind.EXECUTE:
            # Roofline: max of compute time and HBM time for the superblock.
            f = t.flops * self.flops_per_thread
            b = t.flops * self.bytes_per_thread
            return max(f / hw.flops, b / hw.hbm_bw) + hw.task_overhead
        if t.kind is TaskKind.COPY:
            return t.bytes / hw.ici_bw + hw.task_overhead
        if t.kind in (TaskKind.SEND, TaskKind.RECV):
            return t.bytes / hw.net_bw + hw.task_overhead
        if t.kind is TaskKind.REDUCE:
            return t.bytes / hw.hbm_bw + hw.task_overhead
        if t.kind is TaskKind.CREATE_CHUNK:
            return hw.alloc_cost
        if t.kind is TaskKind.SYNC_REPLICAS:
            return t.bytes / hw.ici_bw + hw.task_overhead
        return hw.task_overhead

    @staticmethod
    def _task_size(t: Task) -> int:
        return max(1, t.bytes or (t.region.volume * 4 if t.region else 0))

    # -- simulation -----------------------------------------------------------------

    def run(self, plan: ExecutionPlan, register_chunks: bool = True) -> SimResult:
        plan.validate()
        tasks = plan.tasks
        injector = self.fault_injector
        policy = self.recovery
        rng = random.Random(self.seed)
        indeg = {t.tid: len(t.deps) for t in tasks}
        succ: dict[int, list[int]] = {t.tid: [] for t in tasks}
        for t in tasks:
            for d in t.deps:
                succ[d].append(t.tid)

        if register_chunks:
            for t in tasks:
                w = t.worker % self.num_workers
                for ref in list(t.reads) + list(t.writes):
                    size = self._task_size(t)
                    tier = self.initial_tier
                    if (tier is Tier.DEVICE
                            and self.memory[w].used[Tier.DEVICE] + size
                            > self.memory[w].capacity[Tier.DEVICE]):
                        tier = Tier.HOST  # warm start only while it fits
                    self.memory[w].register(ref.key(), size, tier=tier)

        # Observability: counters on the shared registry; stats becomes the
        # per-run registry delta at the end (compatibility view).
        tracer = self.tracer
        trace_on = tracer.enabled
        reg = self.registry
        sim_c = {k: reg.counter(f"sim.{k}") for k in _SIM_STAT_KEYS}
        reg.counter("sim.tasks_total").inc(len(tasks))
        snap0 = reg.snapshot()

        # Per-worker resource availability times; staging throttle state.
        res_free: dict[tuple[int, str], float] = {}
        staged_bytes = [0.0] * self.num_workers
        busy: dict[str, float] = {}

        # Recovery state.
        attempts: dict[int, int] = {}  # tid -> failed attempts so far
        finished: set[int] = set()
        dead: set[int] = set()
        worker_map = {w: w for w in range(self.num_workers)}
        epoch: dict[int, int] = {t.tid: 0 for t in tasks}  # stale-event guard
        inflight_on: dict[int, int] = {}  # staged/running tid -> worker

        def eff(t: Task) -> int:
            return worker_map[t.worker % self.num_workers]

        # Debug/introspection handles for tests and benchmarks.
        self.worker_map = worker_map
        self.replayed_keys: set[tuple[str, int]] = set()

        # Future-aware eviction: derive a per-chunk next-use table from the
        # plan's task order and install it as the memory managers' Belady
        # oracle.  ``None`` (never used again) sorts as +inf = evict first;
        # otherwise the next unfinished task id that touches the chunk is
        # its "distance".  With eviction="lru" the oracle stays uninstalled
        # and the managers keep their pure-LRU behaviour.
        if self.eviction == "belady":
            next_uses: dict[tuple[str, int], list[int]] = {}
            for t0 in tasks:
                for ref in list(t0.reads) + list(t0.writes):
                    next_uses.setdefault(ref.key(), []).append(t0.tid)
            use_ptr: dict[tuple[str, int], int] = {}

            def next_use_of(key: tuple[str, int]) -> float | None:
                lst = next_uses.get(key)
                if not lst:
                    return None
                i = use_ptr.get(key, 0)
                while i < len(lst) and lst[i] in finished:
                    i += 1
                use_ptr[key] = i
                return None if i >= len(lst) else float(lst[i])

            for m in self.memory:
                m.eviction_oracle = next_use_of
        else:
            for m in self.memory:
                m.eviction_oracle = None

        # d2d transfer fabric: with a topology on the hardware model, every
        # worker gets a ``d2d`` executor stream and chunks that are DEVICE-
        # resident on a live peer stage peer-to-peer over the cheapest link
        # instead of from HOST.  ``mcast_marks`` tracks in-flight multicast
        # pushes (chunk already accounted DEVICE on the receiver, consumer
        # must wait for the modeled arrival).  Without a topology all of
        # this is inert and the schedule stays byte-identical.
        topo = getattr(self.hw, "topology", None)
        d2d_on = topo is not None and self.num_workers > 1
        mcast_on = d2d_on and self.multicast
        mcast_marks: list[dict[tuple[str, int], float]] = [
            {} for _ in range(self.num_workers)
        ]
        readers_by_key = plan.reads_index() if mcast_on else {}
        if d2d_on:
            d2d_bytes_c = reg.counter("d2d.bytes")
            d2d_transfers_c = reg.counter("d2d.transfers")
            mcast_fanout_c = reg.counter("multicast.fanout")

            def _peer_fn(me: int):
                def peer_resident(key: tuple[str, int]) -> bool:
                    for v in range(self.num_workers):
                        if v == me or v in dead:
                            continue
                        c = self.memory[v].chunks.get(key)
                        if c is not None and c.tier is Tier.DEVICE:
                            return True
                    return False
                return peer_resident

            for wi, m in enumerate(self.memory):
                m.peer_resident = _peer_fn(wi)
        else:
            for m in self.memory:
                m.peer_resident = None

        def d2d_sources(w: int, keys) -> dict[tuple[str, int], int]:
            """For each non-resident chunk, the cheapest live peer holding
            it on DEVICE (deterministic: ties break to the lowest id)."""
            out: dict[tuple[str, int], int] = {}
            mm = self.memory[w]
            for k in dict.fromkeys(keys):
                info = mm.chunks.get(k)
                if info is None or info.tier is Tier.DEVICE:
                    continue
                cands = [v for v in range(self.num_workers)
                         if v != w and v not in dead
                         and (c := self.memory[v].chunks.get(k)) is not None
                         and c.tier is Tier.DEVICE]
                if cands:
                    out[k] = topo.cheapest_source(w, cands, info.size)
            return out

        def maybe_multicast(w: int, keys, tiers_before, fetch,
                            avail: float) -> None:
            """Chain-stage each chunk this task freshly host-staged to every
            other live worker that will read it (multicast over the
            topology): k consumers pay one host staging plus k-1 d2d hops
            instead of k independent host stagings.  Receivers are ordered
            same-node first so the chain rides the fast links; pushes use
            only free device capacity and never evict — a receiver that
            can't fit the chunk is skipped and the demand d2d path picks it
            up later."""
            for k in dict.fromkeys(keys):
                if tiers_before.get(k) is Tier.DEVICE or k in fetch:
                    continue  # was already resident, or arrived over d2d
                size = self.memory[w].chunks[k].size
                tgts: list[int] = []
                for tid2 in readers_by_key.get(k, ()):
                    if tid2 in finished or tid2 in inflight_on:
                        continue
                    ww = eff(tasks[tid2])
                    if ww == w or ww in dead or ww in tgts:
                        continue
                    info2 = self.memory[ww].chunks.get(k)
                    if (info2 is None or info2.tier is Tier.DEVICE
                            or k in mcast_marks[ww]):
                        continue
                    tgts.append(ww)
                if not tgts:
                    continue
                tgts.sort(key=lambda ww: (not topo.same_node(w, ww), ww))
                src, tdone, placed = w, avail, 0
                for dst in tgts:
                    if self.memory[dst].receive_d2d(k, evict=False) is None:
                        continue  # no free capacity on the receiver
                    dur = topo.transfer_time(size, src, dst)
                    start = max(tdone, res_free.get((dst, "d2d"), 0.0))
                    res_free[(dst, "d2d")] = start + dur
                    busy["d2d"] = busy.get("d2d", 0.0) + dur
                    mcast_marks[dst][k] = start + dur
                    d2d_bytes_c.inc(size)
                    d2d_transfers_c.inc()
                    placed += 1
                    if trace_on:
                        tracer.complete(
                            f"multicast:{k[0]}", start, dur, worker=dst,
                            stream="d2d", cat="transfer",
                            args={"src": src, "bytes": size},
                        )
                    src, tdone = dst, start + dur
                if placed:
                    mcast_fanout_c.inc(placed)

        # Lookahead prefetcher state: per-worker map of prefetched chunk
        # key -> modeled transfer-completion time, plus in-flight prefetch
        # bytes counted against the staging throttle.
        pf_on = self.prefetch_window > 0
        # How far ahead of `now` the h2d queue may already reach before the
        # prefetcher stops issuing: enough to backfill the gap left by one
        # allocation + bookkeeping, not enough to build a deep queue that
        # would delay demand staging.
        pf_lead_cap = 2.0 * (self.hw.alloc_cost + self.hw.task_overhead)
        prefetched: list[dict[tuple[str, int], float]] = [
            {} for _ in range(self.num_workers)
        ]
        prefetch_bytes = [0.0] * self.num_workers
        producers: dict[tuple[str, int], list[int]] = {}
        pf_lists: dict[int, list[int]] = {}
        pf_ptr: dict[int, int] = {}
        if pf_on:
            for t0 in tasks:
                for ref in t0.writes:
                    producers.setdefault(ref.key(), []).append(t0.tid)

        def rebuild_pf_lists() -> None:
            for ww in range(self.num_workers):
                pf_lists[ww] = []
                pf_ptr[ww] = 0
            for t0 in tasks:
                pf_lists[eff(t0)].append(t0.tid)

        if pf_on:
            rebuild_pf_lists()

        # Event queue: (time, seq, kind, tid, epoch)
        events: list[tuple[float, int, str, int, int]] = []
        seq = 0

        def push(time: float, kind: str, tid: int) -> None:
            nonlocal seq
            heapq.heappush(events, (time, seq, kind, tid, epoch[tid]))
            seq += 1

        def fail(tid: int, stat_key: str, extra_delay: float = 0.0) -> None:
            """Schedule a retry with capped-exponential backoff + jitter."""
            attempts[tid] = attempts.get(tid, 0) + 1
            sim_c["faults_injected"].inc()
            sim_c[stat_key].inc()
            if trace_on:
                tracer.instant(
                    f"fault:{stat_key}", ts=now, worker=eff(tasks[tid]),
                    stream="sched", cat="fault",
                    args={"tid": tid, "attempt": attempts[tid]},
                )
            if attempts[tid] > policy.max_attempts:
                raise RuntimeError(
                    f"task {tid} ({tasks[tid].kind.value}) failed "
                    f"{attempts[tid]} times; recovery gave up"
                )
            push(now + extra_delay + policy.delay(attempts[tid], rng),
                 "ready", tid)

        def kill_worker(w: int) -> None:
            """Worker death: re-plan its tasks onto the survivors (via
            StragglerMonitor.backup_assignment) and recover its chunks from
            replicas or lineage replay."""
            # Lazy import: repro_torch.dist imports repro_torch.core at
            # module load, so a top-level import here would be circular.
            from repro_torch.dist.fault import HeartbeatMonitor, \
                StragglerMonitor

            dead.add(w)
            sim_c["worker_deaths"].inc()
            if trace_on:
                tracer.instant("worker_death", ts=now, worker=w,
                               stream="sched", cat="fault")
            mon = HeartbeatMonitor(num_hosts=self.num_workers)
            for h in range(self.num_workers):
                if h in dead:
                    mon.hosts[h].quarantined = True
                else:
                    mon.beat(h, 1.0)
            assignment = StragglerMonitor(mon).backup_assignment(
                data_shards=self.num_workers
            )
            shard_to_host = {s: h for h, shards in assignment.items()
                             for s in shards}
            for orig in range(self.num_workers):
                worker_map[orig] = (orig if orig not in dead
                                    else shard_to_host[orig])

            # Chunks lost with the worker: if a surviving worker holds a
            # replica the migration below re-fetches it; otherwise replay
            # the lineage (the latest finished producer recomputes the
            # chunk on its new home).  This analysis must run BEFORE the
            # migration re-registers anything, or a chunk that lived only
            # on the dead worker would masquerade as a survivor replica.
            pending_reads = {
                ref.key() for t2 in tasks if t2.tid not in finished
                for ref in t2.reads
            }
            lost = sorted(set(self.memory[w].chunks) & pending_reads)
            replayed: set = set()
            for key in lost:
                if any(key in self.memory[sv].chunks
                       for sv in range(self.num_workers) if sv not in dead):
                    sim_c["replica_recoveries"].inc()
                    continue
                ptid = None
                if self.chunk_state is not None:
                    cand = self.chunk_state.last_writer_of(key)
                    if cand is not None and cand in finished:
                        ptid = cand
                if ptid is None:
                    done_producers = [p for p in plan.producers_of(key)
                                      if p in finished]
                    ptid = done_producers[-1] if done_producers else None
                if ptid is None:
                    continue  # never-written input: re-fetch is the register
                replayed.add(key)
                push(now, "replay", ptid)

            # Migrate pending tasks' chunk registrations to their new homes
            # (re-fetched into HOST tier; staging pays the promote cost).
            # Keys awaiting lineage replay are skipped — replay_done
            # registers them once the recompute lands.
            if register_chunks:
                for t2 in tasks:
                    if t2.tid in finished:
                        continue
                    orig = t2.worker % self.num_workers
                    if orig not in dead:
                        continue
                    nw = worker_map[orig]
                    for ref in list(t2.reads) + list(t2.writes):
                        if ref.key() in replayed:
                            continue
                        self.memory[nw].register(
                            ref.key(), self._task_size(t2), tier=Tier.HOST
                        )

            # Tasks mid-flight on the dead worker: invalidate their queued
            # events (epoch bump) and reschedule on the survivors.
            for tid, home in sorted(inflight_on.items()):
                if home != w:
                    continue
                del inflight_on[tid]
                epoch[tid] += 1
                sim_c["tasks_rescheduled"].inc()
                push(now + policy.delay(1, rng), "ready", tid)
            staged_bytes[w] = 0.0
            self.replayed_keys.update(replayed)
            if pf_on:
                # Death invalidates in-flight transfer timing and remaps
                # task homes: drop every prefetch mark (resident chunks
                # simply become zero-cost demand stages) and re-derive the
                # per-worker lookahead order from the new effective homes.
                for ww in range(self.num_workers):
                    prefetched[ww].clear()
                    prefetch_bytes[ww] = 0.0
                rebuild_pf_lists()
            if d2d_on:
                # In-flight multicast arrival times may reference the dead
                # worker as a chain hop; drop every mark (chunks already
                # placed simply become zero-wait residents, and the dead
                # worker is excluded as a source from here on).
                for ww in range(self.num_workers):
                    mcast_marks[ww].clear()
            release_throttled(w)

        for t in tasks:
            if indeg[t.tid] == 0:
                push(0.0, "ready", t.tid)

        now = 0.0
        completed = 0
        # Deferred tasks waiting on the staging throttle, per worker.
        throttled: dict[int, list[int]] = {w: [] for w in range(self.num_workers)}
        throttled_since: dict[int, float] = {}  # tid -> when it was deferred
        self.throttled_since = throttled_since  # test/introspection handle

        def release_throttled(w: int) -> None:
            if not throttled[w]:
                return
            pending, throttled[w] = throttled[w], []
            for p in pending:
                sim_c["stage_wait"].inc(now - throttled_since.pop(p, now))
                push(now, "ready", p)

        def upcoming(w: int):
            """Upcoming tasks homed on ``w`` in plan order — everything not
            finished and not already staged/running.  Window accounting
            (and skip-and-continue over producer-blocked tasks) lives in
            ``maybe_prefetch``."""
            lst = pf_lists[w]
            i = pf_ptr[w]
            while i < len(lst) and lst[i] in finished:
                i += 1  # skip (and permanently drop) the finished prefix
            pf_ptr[w] = i
            while i < len(lst):
                tid2 = lst[i]
                if tid2 not in finished and tid2 not in inflight_on:
                    yield tasks[tid2]
                i += 1

        def maybe_prefetch(w: int) -> None:
            """Issue transfers for upcoming tasks' dependency-satisfied
            chunks while compute runs — over the d2d stream when a live
            peer already holds the chunk on-device, the h2d stream
            otherwise.  Three bounds keep lookahead from hurting: the
            staging throttle (prefetch depth trades against contention,
            paper §3.3), free device capacity (a prefetch never evicts
            resident data), and — critically — the prefetcher only
            *backfills an idle stream*: if the queue has pending work,
            issuing ahead of it would delay demand traffic, so we wait for
            the next trigger instead.  One transfer per idle gap gives
            classic double-buffering without unbounded queue build-up.

            A task whose every missing chunk still awaits its producer does
            not consume a window slot: the scan skips it (counted under
            ``prefetch_skipped``) and keeps looking across superblock
            boundaries, up to ``_PF_SCAN_FACTOR ×`` the window."""
            if not pf_on or w in dead:
                return
            h2d_key = (w, "h2d")
            mm = self.memory[w]
            budget = (self.hw.staging_throttle - staged_bytes[w]
                      - prefetch_bytes[w])
            lead_cap = pf_lead_cap
            window = self.prefetch_window
            scan_cap = window * _PF_SCAN_FACTOR
            counted = scanned = 0
            for t2 in upcoming(w):
                if counted >= window or scanned >= scan_cap:
                    return
                scanned += 1
                nrefs = blocked = 0
                for ref in list(t2.reads) + list(t2.writes):
                    nrefs += 1
                    key = ref.key()
                    if key in prefetched[w]:
                        continue
                    info = mm.chunks.get(key)
                    if info is None or info.tier is Tier.DEVICE or info.pinned:
                        continue
                    prods = producers.get(key)
                    if prods and any(p != t2.tid and p not in finished
                                     for p in prods):
                        blocked += 1
                        continue  # producer pending: data does not exist yet
                    src = None
                    if d2d_on:
                        cands = [v for v in range(self.num_workers)
                                 if v != w and v not in dead
                                 and (c := self.memory[v].chunks.get(key))
                                 is not None and c.tier is Tier.DEVICE]
                        if cands:
                            src = topo.cheapest_source(w, cands, info.size)
                    stream_key = (w, "d2d") if src is not None else h2d_key
                    if res_free.get(stream_key, 0.0) > now + lead_cap:
                        return  # stream busy: never queue far ahead of demand
                    if info.size > budget:
                        return  # throttle-bound: stop this round
                    if src is not None:
                        if mm.receive_d2d(key, evict=False) is None:
                            return  # no free device capacity left
                        cost = topo.transfer_time(info.size, src, w)
                        d2d_bytes_c.inc(info.size)
                        d2d_transfers_c.inc()
                    else:
                        cost = mm.prefetch_one(key)
                        if cost is None:
                            return  # no free device capacity left
                    budget -= info.size
                    prefetch_bytes[w] += info.size
                    start = max(now, res_free.get(stream_key, 0.0))
                    res_free[stream_key] = start + cost
                    busy[stream_key[1]] = busy.get(stream_key[1], 0.0) + cost
                    prefetched[w][key] = start + cost
                    sim_c["prefetch_issued"].inc()
                    sim_c["prefetch_bytes"].inc(info.size)
                    if trace_on and cost > 0.0:
                        pf_args = {"tid": t2.tid, "bytes": info.size}
                        if src is not None:
                            pf_args["src"] = src
                        tracer.complete(
                            f"prefetch:{key[0]}", start, cost, worker=w,
                            stream=stream_key[1], cat="transfer",
                            args=pf_args,
                        )
                if nrefs and blocked == nrefs:
                    sim_c["prefetch_skipped"].inc()
                    continue  # fully producer-blocked: free the window slot
                counted += 1

        # Memory managers stamp their spill/evict/OOM instants with the
        # current simulated time (closure over this loop's ``now``).
        for m in self.memory:
            m.clock = lambda: now

        # Warm the pipeline: with lookahead enabled, input transfers start
        # at t=0 instead of queueing behind partial-buffer allocations.
        for ww in range(self.num_workers):
            maybe_prefetch(ww)

        while events:
            now, _, kind, tid, ep = heapq.heappop(events)
            if ep != epoch[tid]:
                continue  # event from before this task's worker died
            t = tasks[tid]
            w = eff(t)

            if kind == "ready":
                footprint = sum(
                    self.memory[w].chunks[r.key()].size
                    for r in list(t.reads) + list(t.writes)
                    if r.key() in self.memory[w].chunks
                )
                keys = [r.key() for r in list(t.reads) + list(t.writes)
                        if r.key() in self.memory[w].chunks]
                if pf_on:
                    # Chunks already prefetched (or in flight on h2d) only
                    # count once against the throttle; the remainder is
                    # what this staging would newly put in flight.
                    consumed = list(dict.fromkeys(
                        k for k in keys if k in prefetched[w]
                    ))
                    new_bytes = footprint - sum(
                        self.memory[w].chunks[k].size for k in consumed
                    )
                    over = (staged_bytes[w] + prefetch_bytes[w] + new_bytes
                            > self.hw.staging_throttle)
                else:
                    consumed = []
                    over = (staged_bytes[w] + footprint
                            > self.hw.staging_throttle)
                if over and staged_bytes[w] > 0:
                    throttled[w].append(tid)
                    throttled_since.setdefault(tid, now)
                    continue
                # Stage chunks (h2d resource serializes transfers).  With a
                # topology, chunks DEVICE-resident on a live peer arrive
                # over the d2d stream instead (placed before ``stage`` so
                # the host path never re-pays them); chunks pushed here by
                # an in-flight multicast contribute their arrival time.
                pre_resident = {
                    k for k in consumed
                    if self.memory[w].chunks[k].tier is Tier.DEVICE
                }
                fetch = d2d_sources(w, keys) if d2d_on else {}
                tiers_before = (
                    {k: self.memory[w].chunks[k].tier
                     for k in dict.fromkeys(keys)}
                    if mcast_on else {}
                )
                mcast_wait = now
                if d2d_on and mcast_marks[w]:
                    for k in dict.fromkeys(keys):
                        if k in mcast_marks[w]:
                            mcast_wait = max(mcast_wait,
                                             mcast_marks[w].pop(k))
                try:
                    d2d_room: dict[tuple[str, int], float] = {}
                    for k in sorted(fetch):
                        room = self.memory[w].receive_d2d(k)
                        if room is None:
                            del fetch[k]  # raced to DEVICE meanwhile
                        else:
                            d2d_room[k] = room
                    stage_cost = self.memory[w].stage(keys)
                except OutOfMemory:
                    sim_c["oom_events"].inc()
                    if attempts.get(tid, 0) >= policy.max_attempts:
                        raise  # degradation exhausted: surface the real OOM
                    delay = 0.0
                    if attempts.get(tid, 0) >= policy.oom_degrade_after:
                        # Repeated pressure: demote the tier instead of
                        # hammering the same capacity again.
                        spill = self.memory[w].degrade()
                        if spill is not None:
                            sim_c["oom_degradations"].inc()
                            delay += spill
                    fail(tid, "task_retries", extra_delay=delay)
                    continue
                staged_bytes[w] += footprint
                inflight_on[tid] = w
                h2d_key = (w, "h2d")
                # Issue the peer-to-peer transfers on this worker's d2d
                # stream; any spill cost from making room is folded into
                # the first hop of the corresponding transfer.
                d2d_end = now
                if fetch:
                    d2d_key = (w, "d2d")
                    for k in sorted(fetch):
                        src = fetch[k]
                        size = self.memory[w].chunks[k].size
                        dur = (d2d_room.get(k, 0.0)
                               + topo.transfer_time(size, src, w))
                        start = max(now, res_free.get(d2d_key, 0.0))
                        res_free[d2d_key] = start + dur
                        busy["d2d"] = busy.get("d2d", 0.0) + dur
                        d2d_bytes_c.inc(size)
                        d2d_transfers_c.inc()
                        if trace_on:
                            tracer.complete(
                                f"d2d:{k[0]}", start, dur, worker=w,
                                stream="d2d", cat="transfer",
                                args={"tid": tid, "src": src,
                                      "bytes": size},
                            )
                    d2d_end = res_free[d2d_key]
                extra_wait = max(d2d_end, mcast_wait)
                if pf_on:
                    # Consume prefetch marks: the task may not run before
                    # its prefetched transfers land, but it does not pay
                    # for them (or queue on h2d) again.  A mark whose chunk
                    # was evicted before use is a wasted prefetch — the
                    # stage above already re-paid the transfer.
                    wait_until = now
                    for k in consumed:
                        wait_until = max(wait_until,
                                         prefetched[w].pop(k, now))
                        prefetch_bytes[w] = max(
                            0.0, prefetch_bytes[w]
                            - self.memory[w].chunks[k].size)
                        if k in pre_resident:
                            sim_c["prefetch_hits"].inc()
                        else:
                            sim_c["prefetch_wasted"].inc()
                    if stage_cost > 0.0:
                        start = max(now, res_free.get(h2d_key, 0.0))
                        res_free[h2d_key] = start + stage_cost
                        busy["h2d"] = busy.get("h2d", 0.0) + stage_cost
                        if trace_on:
                            tracer.complete(
                                f"stage:{t.label or t.kind.value}", start,
                                stage_cost, worker=w, stream="h2d",
                                cat="transfer",
                                args={"tid": tid, "bytes": footprint},
                            )
                        push(max(start + stage_cost, wait_until,
                                 extra_wait), "staged", tid)
                        if mcast_on:
                            maybe_multicast(w, keys, tiers_before, fetch,
                                            start + stage_cost)
                    else:
                        # Fast path: everything already resident — no need
                        # to queue behind unrelated h2d traffic.
                        push(max(now, wait_until, extra_wait), "staged", tid)
                    maybe_prefetch(w)
                else:
                    start = max(now, res_free.get(h2d_key, 0.0))
                    res_free[h2d_key] = start + stage_cost
                    busy["h2d"] = busy.get("h2d", 0.0) + stage_cost
                    if trace_on and stage_cost > 0.0:
                        tracer.complete(
                            f"stage:{t.label or t.kind.value}", start,
                            stage_cost, worker=w, stream="h2d",
                            cat="transfer",
                            args={"tid": tid, "bytes": footprint},
                        )
                    push(max(start + stage_cost, extra_wait), "staged", tid)
                    if mcast_on and stage_cost > 0.0:
                        maybe_multicast(w, keys, tiers_before, fetch,
                                        start + stage_cost)

            elif kind == "staged":
                resource = _EXECUTOR_FOR[t.kind]
                rkey = (w, resource)
                dur = self._duration(t)
                start = max(now, res_free.get(rkey, 0.0))
                res_free[rkey] = start + dur
                busy[resource] = busy.get(resource, 0.0) + dur
                if trace_on:
                    tracer.complete(
                        f"{t.kind.value}:{t.label or tid}", start, dur,
                        worker=w, stream=resource,
                        cat=_CAT_FOR_RESOURCE.get(resource, "compute"),
                        args={"tid": tid,
                              "attempt": attempts.get(tid, 0)},
                    )
                push(start + dur, "done", tid)
                maybe_prefetch(w)  # compute launched: top up the lookahead

            elif kind == "done":
                keys = [r.key() for r in list(t.reads) + list(t.writes)
                        if r.key() in self.memory[w].chunks]
                self.memory[w].unstage(keys)
                footprint = sum(self.memory[w].chunks[k].size for k in keys)
                staged_bytes[w] = max(0.0, staged_bytes[w] - footprint)
                inflight_on.pop(tid, None)
                release_throttled(w)

                # Did this attempt fail?  (Injected task faults, transfer
                # timeouts and corruptions are detected at completion.)
                if injector is not None:
                    if t.kind in _TRANSFER_KINDS:
                        if injector.probe("transfer_timeout", worker=w,
                                          task=tid, site=t.label):
                            fail(tid, "transfer_retries",
                                 extra_delay=policy.transfer_timeout)
                            continue
                        if injector.probe("transfer_corrupt", worker=w,
                                          task=tid, site=t.label):
                            fail(tid, "transfer_retries")
                            continue
                    if injector.probe("task", worker=w, task=tid,
                                      site=t.label):
                        fail(tid, "task_retries")
                        continue

                finished.add(tid)
                completed += 1
                if attempts.get(tid, 0) > 0:
                    sim_c["recovered_tasks"].inc()
                for s in succ[tid]:
                    indeg[s] -= 1
                    if indeg[s] == 0:
                        push(now, "ready", s)
                if (injector is not None and w not in dead
                        and injector.probe("worker_death", worker=w)):
                    kill_worker(w)
                if pf_on:
                    # A completion can satisfy producers for any worker's
                    # upcoming tasks (and idle workers get no events of
                    # their own), so top everyone up.
                    for ww in range(self.num_workers):
                        maybe_prefetch(ww)

            elif kind == "replay":
                # Lineage replay: recompute a lost chunk by re-running its
                # finished producer on that producer's (remapped) worker.
                resource = _EXECUTOR_FOR[t.kind]
                rkey = (w, resource)
                dur = self._duration(t)
                start = max(now, res_free.get(rkey, 0.0))
                res_free[rkey] = start + dur
                busy[resource] = busy.get(resource, 0.0) + dur
                if trace_on:
                    tracer.complete(
                        f"replay:{t.label or tid}", start, dur, worker=w,
                        stream=resource,
                        cat=_CAT_FOR_RESOURCE.get(resource, "compute"),
                        args={"tid": tid},
                    )
                push(start + dur, "replay_done", tid)

            elif kind == "replay_done":
                sim_c["lineage_replays"].inc()
                size = self._task_size(t)
                for ref in t.writes:
                    key = ref.key()
                    # The recompute lands on the producer's remapped worker,
                    # but pending consumers may have been remapped elsewhere
                    # (two deaths, different survivors): register the chunk
                    # on every effective worker that still needs it, or
                    # their staging would never see it.
                    homes = {w}
                    for t2 in tasks:
                        if t2.tid in finished:
                            continue
                        if any(r.key() == key for r in t2.reads):
                            homes.add(eff(t2))
                    for home in sorted(homes):
                        if home in dead:
                            continue
                        self.memory[home].register(key, size, tier=Tier.HOST)

        if completed != len(tasks):
            raise RuntimeError(
                f"simulation deadlock: {completed}/{len(tasks)} tasks ran"
            )
        # Compatibility view: this run's registry delta as a plain dict.
        # Memory-manager totals come from the labeled parents (``mem.*``)
        # — the registry aggregates across workers, so nothing is summed
        # by hand here anymore.
        delta = MetricsRegistry.diff(reg.snapshot(), snap0)
        stats = {k: delta.get(f"sim.{k}", 0.0) for k in _SIM_STAT_KEYS}
        for k in MEM_STAT_KEYS:
            stats[k] = delta.get(f"mem.{k}", 0.0)
        stats["d2d_bytes"] = delta.get("d2d.bytes", 0.0)
        stats["d2d_transfers"] = delta.get("d2d.transfers", 0.0)
        stats["multicast_fanout"] = delta.get("multicast.fanout", 0.0)
        return SimResult(
            makespan=now, busy=busy, task_count=len(tasks), stats=stats,
            num_workers=self.num_workers,
        )

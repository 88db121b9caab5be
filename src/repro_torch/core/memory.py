"""Memory manager with hierarchical spilling (paper §3.4).

Every worker owns a memory manager that tracks where each chunk lives —
device memory (HBM), host memory, or disk — and migrates chunks on demand:

* **staging** materializes a task's chunks in device memory before execution
  (all-or-nothing per task, to avoid deadlock);
* when a tier is full, **least-recently-used unpinned chunks are evicted** to
  the next tier (HBM → host → disk);
* allocation uses pre-sized pools (the paper found cudaMalloc/pinned-alloc
  expensive; we model pool hits as free and pool misses with a fixed cost);
* repeated :class:`OutOfMemory` pressure triggers **graceful degradation**
  (:meth:`MemoryManager.degrade`): the effective device capacity shrinks and
  unpinned chunks spill harder, instead of the whole plan aborting.  A
  :class:`~repro_torch.core.faults.FaultInjector` can be threaded in to raise
  spurious OOMs deterministically so the degradation path is testable.

On the GPU the HBM↔host tier is what :mod:`repro_torch.core.streaming` runs:
host-resident data copied through pinned staging buffers into device
memory, chunk by chunk.  This module is the discrete-cost model the
scheduler simulator uses to reproduce the paper's chunk-size and spilling
experiments (C1/C2) on a CPU, and to predict what the streaming path should
take on the card (:class:`HardwareModel` defaults to an NVIDIA H100).
"""

from __future__ import annotations

import dataclasses
import enum
from collections import OrderedDict

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import NULL_TRACER


class Tier(enum.IntEnum):
    DEVICE = 0
    HOST = 1
    DISK = 2


#: Per-worker counters the memory manager maintains on the metrics
#: registry (``mem.<key>``, labeled by worker).  ``MemoryManager.stats``
#: and ``SimResult.stats`` expose them under these bare keys.
MEM_STAT_KEYS = (
    "h2d_bytes", "d2h_bytes", "host2disk_bytes", "disk2host_bytes",
    "evictions", "pool_misses", "oom_demotions", "oracle_evictions",
    "prefetch_bytes", "d2d_in_bytes", "peer_evictions",
)


@dataclasses.dataclass(frozen=True)
class Interconnect:
    """Device-to-device interconnect topology (paper §3.1: nodes of GPUs
    linked by PCIe/NVLink internally and InfiniBand across nodes).

    Workers are grouped into nodes by contiguous id
    (``node(w) = w // workers_per_node``); a same-node link is faster and
    lower-latency than a cross-node one.  Installing an ``Interconnect`` on
    :class:`HardwareModel.topology` enables the scheduler's peer-to-peer
    ``d2d`` staging path; with ``topology=None`` (the default) every
    cross-worker chunk moves through the host exactly as before."""

    workers_per_node: int = 4
    same_node_bw: float = 13e9  # P2P over PCIe within a node (bytes/s)
    cross_node_bw: float = 5e9  # GPUDirect RDMA over the fabric (bytes/s)
    same_node_latency: float = 5e-6  # seconds per transfer
    cross_node_latency: float = 20e-6

    def node(self, worker: int) -> int:
        return worker // self.workers_per_node

    def same_node(self, a: int, b: int) -> bool:
        return self.node(a) == self.node(b)

    def link(self, src: int, dst: int) -> tuple[float, float]:
        """(bandwidth bytes/s, latency s) of the src→dst link."""
        if self.same_node(src, dst):
            return self.same_node_bw, self.same_node_latency
        return self.cross_node_bw, self.cross_node_latency

    def transfer_time(self, nbytes: float, src: int, dst: int) -> float:
        bw, lat = self.link(src, dst)
        return lat + nbytes / bw

    def cheapest_source(self, dst: int, candidates: "list[int]",
                        nbytes: float = 1 << 20) -> int:
        """The candidate with the cheapest link into ``dst`` (ties break
        toward the lowest worker id, so routing is deterministic)."""
        return min(candidates,
                   key=lambda c: (self.transfer_time(nbytes, c, dst), c))

    @staticmethod
    def paper_cluster() -> "Interconnect":
        """The paper's evaluation cluster: 4 nodes × 4 P100s, P2P over
        PCIe 3.0 inside a node, InfiniBand FDR between nodes."""
        return Interconnect(
            workers_per_node=4,
            same_node_bw=13e9,
            cross_node_bw=7e9,  # IB FDR, matches HardwareModel.net_bw
            same_node_latency=5e-6,
            cross_node_latency=20e-6,
        )


@dataclasses.dataclass
class HardwareModel:
    """Cost-model constants.  Defaults are one NVIDIA H100 SXM5 80GB at its
    700 W limit, from the card's data sheet, with the paper's host, disk,
    network and scheduler costs; ``paper_p100()`` gives the paper's
    platform for figure reproduction."""

    # Peak FLOP/s: FP32 on the CUDA cores, not bf16 on the tensor cores —
    # the paper's kernels and the K-Means scenario compute in f32.
    flops: float = 67e12
    hbm_bw: float = 3.35e12  # bytes/s (HBM3)
    device_capacity: float = 80e9  # bytes HBM
    host_link_bw: float = 64e9  # device<->host B/s (PCIe Gen5 x16, one way)
    host_capacity: float = 448e9
    disk_bw: float = 1.0e9
    disk_capacity: float = 3e12
    net_bw: float = 7e9  # inter-node per-link (IB FDR in the paper)
    # Peer-to-peer per direction (NVLink 4, data sheet's figure: a
    # one-card machine cannot measure it).
    ici_bw: float = 450e9
    task_overhead: float = 50e-6  # scheduler+launch overhead per task
    alloc_cost: float = 200e-6  # pool-miss allocation
    staging_throttle: float = 2e9  # max bytes staged in flight (paper: 2 GB)
    # Peer-to-peer interconnect; None keeps every cross-worker transfer on
    # the host path (byte-identical to the pre-d2d scheduler).
    topology: "Interconnect | None" = None

    @staticmethod
    def paper_p100() -> "HardwareModel":
        return HardwareModel(
            flops=9.5e12,  # P100 fp32 (with FMA) ~9.5 TFLOP/s — SGEMM-like
            hbm_bw=732e9,
            device_capacity=16e9,
            host_link_bw=16e9,  # PCIe 3.0 x16
            host_capacity=448e9,
            disk_bw=1.0e9,  # temp SSD
            disk_capacity=3e12,
            net_bw=7e9,  # InfiniBand FDR
            ici_bw=16e9,  # P2P over PCIe
        )

    @staticmethod
    def paper_cluster() -> "HardwareModel":
        """The paper's full platform: P100 nodes plus the d2d fabric."""
        return dataclasses.replace(
            HardwareModel.paper_p100(), topology=Interconnect.paper_cluster()
        )


@dataclasses.dataclass
class ChunkInfo:
    key: tuple[str, int]
    size: int
    tier: Tier = Tier.HOST
    pinned: int = 0  # staged-task refcount; pinned chunks cannot evict


class OutOfMemory(RuntimeError):
    pass


class MemoryManager:
    """LRU spilling across DEVICE → HOST → DISK for one worker."""

    def __init__(self, hw: HardwareModel, injector=None, worker: int | None = None,
                 degrade_factor: float = 0.75,
                 min_device_fraction: float = 0.25,
                 registry: MetricsRegistry | None = None,
                 tracer=None):
        self.hw = hw
        self.injector = injector  # FaultInjector | None (spurious OOMs)
        self.worker = worker
        self.degrade_factor = float(degrade_factor)
        self.min_device_fraction = float(min_device_fraction)
        self.capacity = {
            Tier.DEVICE: hw.device_capacity,
            Tier.HOST: hw.host_capacity,
            Tier.DISK: hw.disk_capacity,
        }
        self.used = {t: 0.0 for t in Tier}
        self.chunks: dict[tuple[str, int], ChunkInfo] = {}
        # LRU order per tier (front = least recently used).
        self.lru: dict[Tier, OrderedDict] = {t: OrderedDict() for t in Tier}
        # Observability: counters/gauges live on the (possibly shared)
        # registry — the scheduler aggregates across workers through the
        # labeled parents instead of summing dicts by hand.  ``clock`` can
        # be injected (the simulator points it at simulated time) so the
        # spill/evict/OOM instants land on the right timeline.
        self.registry = registry or MetricsRegistry()
        self.tracer = tracer or NULL_TRACER
        self.clock = None
        # Optional future-knowledge eviction oracle (Belady): maps a chunk
        # key to its next-use distance (larger = used further in the future;
        # ``None``/``inf`` = never used again).  Installed by the scheduler
        # from the ExecutionPlan task order; without one, eviction falls
        # back to pure LRU.
        self.eviction_oracle = None
        # Optional peer-residency predicate (installed by the scheduler when
        # a d2d topology is configured): ``peer_resident(key) -> bool`` says
        # a live peer worker holds this chunk in DEVICE memory, which makes
        # it a cheap eviction victim — it can come back over the fast d2d
        # link instead of the host link.
        self.peer_resident = None
        wl = {"worker": str(worker if worker is not None else 0)}
        self._stat = {
            k: self.registry.counter(f"mem.{k}").labels(**wl)
            for k in MEM_STAT_KEYS
        }
        self._occupancy = {
            t: self.registry.gauge("mem.tier_bytes").labels(
                tier=t.name, **wl
            )
            for t in Tier
        }

    @property
    def stats(self) -> dict[str, float]:
        """This worker's counters as a plain dict (compatibility view)."""
        return {k: c.value() for k, c in self._stat.items()}

    def _ts(self) -> float:
        return self.clock() if self.clock is not None else self.tracer.now()

    def _event(self, name: str, **args) -> None:
        if self.tracer.enabled:
            self.tracer.instant(
                name, ts=self._ts(),
                worker=self.worker if self.worker is not None else 0,
                stream="mem", cat="mem", args=args,
            )

    # -- bookkeeping ---------------------------------------------------------

    def register(self, key: tuple[str, int], size: int,
                 tier: Tier = Tier.HOST) -> None:
        if key in self.chunks:
            return
        info = ChunkInfo(key, size, tier)
        self.chunks[key] = info
        self._account_add(info, tier)

    def delete(self, key: tuple[str, int]) -> None:
        info = self.chunks.pop(key, None)
        if info is not None:
            self._account_remove(info)

    def _account_add(self, info: ChunkInfo, tier: Tier) -> None:
        info.tier = tier
        self.used[tier] += info.size
        self.lru[tier][info.key] = None
        self._occupancy[tier].set(self.used[tier])

    def _account_remove(self, info: ChunkInfo) -> None:
        self.used[info.tier] -= info.size
        self.lru[info.tier].pop(info.key, None)
        self._occupancy[info.tier].set(self.used[info.tier])

    def touch(self, key: tuple[str, int]) -> None:
        info = self.chunks[key]
        self.lru[info.tier].move_to_end(info.key)

    # -- staging ----------------------------------------------------------------

    def stage(self, keys: list[tuple[str, int]]) -> float:
        """Materialize all chunks in DEVICE memory (all-or-nothing) and pin
        them.  Returns the modeled transfer time (seconds) this staging
        costs; concurrent stagings overlap in the scheduler."""
        if self.injector is not None and self.injector.probe(
            "oom", worker=self.worker, site="stage"
        ):
            self._event("oom", kind="injected")
            raise OutOfMemory("injected: spurious allocation failure")
        total_new = sum(
            self.chunks[k].size for k in keys
            if self.chunks[k].tier != Tier.DEVICE
        )
        pinned_dev = sum(
            c.size for c in self.chunks.values()
            if c.tier is Tier.DEVICE and c.pinned > 0
        )
        if total_new + pinned_dev > self.capacity[Tier.DEVICE]:
            self._event("oom", kind="working_set",
                        bytes=total_new + pinned_dev)
            raise OutOfMemory(
                f"task working set {total_new + pinned_dev:.3e} B exceeds "
                f"device capacity {self.capacity[Tier.DEVICE]:.3e} B"
            )
        cost = 0.0
        for k in keys:
            info = self.chunks[k]
            if info.tier is not Tier.DEVICE:
                cost += self._promote(info)
            info.pinned += 1
            self.touch(k)
        return cost

    def unstage(self, keys: list[tuple[str, int]]) -> None:
        for k in keys:
            info = self.chunks.get(k)
            if info is not None and info.pinned > 0:
                info.pinned -= 1

    def prefetch_one(self, key: tuple[str, int]) -> float | None:
        """Lookahead staging: promote one chunk to DEVICE *without* pinning
        it, and only into free capacity — a prefetch never evicts resident
        data (the demand path with its oracle-guided eviction does that).
        Returns the modeled transfer seconds, or ``None`` when the chunk is
        unknown, already resident, or does not fit."""
        info = self.chunks.get(key)
        if info is None or info.tier is Tier.DEVICE:
            return None
        if self.used[Tier.DEVICE] + info.size > self.capacity[Tier.DEVICE]:
            return None
        cost = self._promote(info)
        self.touch(key)
        self._stat["prefetch_bytes"].inc(info.size)
        return cost

    def receive_d2d(self, key: tuple[str, int],
                    evict: bool = True) -> float | None:
        """Place a chunk in DEVICE memory as the target of a peer-to-peer
        transfer: no host-link cost is charged (the scheduler models the
        link time on the ``d2d`` stream).  With ``evict=True`` (demand
        staging) resident chunks may spill to make room and the modeled
        spill seconds are returned; with ``evict=False`` (multicast /
        prefetch push) only free capacity is used.  Returns ``None`` when
        the chunk is unknown, already resident, or — under ``evict=False``
        — does not fit."""
        info = self.chunks.get(key)
        if info is None or info.tier is Tier.DEVICE:
            return None
        if not evict and (self.used[Tier.DEVICE] + info.size
                          > self.capacity[Tier.DEVICE]):
            return None
        cost = self._make_room(Tier.DEVICE, info.size) if evict else 0.0
        self._account_remove(info)
        self._account_add(info, Tier.DEVICE)
        self.touch(key)
        self._stat["d2d_in_bytes"].inc(info.size)
        return cost

    # -- migration ---------------------------------------------------------------

    def _promote(self, info: ChunkInfo) -> float:
        """Bring a chunk up one or two tiers into DEVICE; returns seconds."""
        cost = 0.0
        if info.tier is Tier.DISK:
            cost += self._make_room(Tier.HOST, info.size)
            cost += info.size / self.hw.disk_bw
            self._stat["disk2host_bytes"].inc(info.size)
            self._account_remove(info)
            self._account_add(info, Tier.HOST)
        if info.tier is Tier.HOST:
            cost += self._make_room(Tier.DEVICE, info.size)
            cost += info.size / self.hw.host_link_bw
            self._stat["h2d_bytes"].inc(info.size)
            self._account_remove(info)
            self._account_add(info, Tier.DEVICE)
        return cost

    def _pick(self, candidates: list) -> tuple[str, int] | None:
        """Apply the eviction policy to an ordered candidate list: LRU front
        with no oracle, otherwise the candidate whose next use is furthest
        in the future (Belady), breaking ties toward LRU order (the list is
        iterated front = least recently used, so ties keep the older one)."""
        oracle = self.eviction_oracle
        if oracle is None:
            return candidates[0] if candidates else None
        best_key, best_dist = None, -1.0
        for k in candidates:
            d = oracle(k)
            d = float("inf") if d is None else float(d)
            if d > best_dist:
                best_key, best_dist = k, d
        return best_key

    def _victim_key(self, tier: Tier) -> tuple[str, int] | None:
        """Pick the eviction victim for ``tier``.  When the scheduler has
        installed a ``peer_resident`` predicate (d2d topology configured),
        DEVICE chunks that a live peer also holds on-device are preferred
        victims: losing one is cheap because it can come back over the d2d
        link instead of the host link.  Within either pool the policy is
        LRU, or Belady next-use distance when an oracle is installed."""
        unpinned = [k for k in self.lru[tier]
                    if self.chunks[k].pinned == 0]
        peer = self.peer_resident if tier is Tier.DEVICE else None
        if peer is not None:
            replicated = [k for k in unpinned if peer(k)]
            victim = self._pick(replicated)
            if victim is not None:
                self._stat["peer_evictions"].inc()
                if self.eviction_oracle is not None:
                    self._stat["oracle_evictions"].inc()
                return victim
        victim = self._pick(unpinned)
        if victim is not None and self.eviction_oracle is not None:
            self._stat["oracle_evictions"].inc()
        return victim

    def _make_room(self, tier: Tier, size: int) -> float:
        cost = 0.0
        while self.used[tier] + size > self.capacity[tier]:
            victim_key = self._victim_key(tier)
            if victim_key is None:
                self._event("oom", kind="all_pinned", tier=tier.name)
                raise OutOfMemory(
                    f"cannot free {size:.3e} B in {tier.name}: all pinned"
                )
            victim = self.chunks[victim_key]
            cost += self._demote(victim)
            self._stat["evictions"].inc()
        return cost

    def _demote(self, info: ChunkInfo) -> float:
        nxt = Tier(info.tier + 1)
        cost = self._make_room(nxt, info.size)
        if info.tier is Tier.DEVICE:
            cost += info.size / self.hw.host_link_bw
            self._stat["d2h_bytes"].inc(info.size)
        else:
            cost += info.size / self.hw.disk_bw
            self._stat["host2disk_bytes"].inc(info.size)
        self._event("spill", frm=info.tier.name, to=nxt.name,
                    bytes=info.size)
        self._account_remove(info)
        self._account_add(info, nxt)
        return cost

    # -- graceful degradation -----------------------------------------------------

    def degrade(self) -> float | None:
        """Shrink the effective DEVICE capacity by ``degrade_factor`` and
        spill unpinned device chunks until usage fits again.

        Models a device losing usable HBM under pressure (fragmentation,
        another tenant, a flaky allocator): subsequent stagings spill
        harder instead of the run aborting.  Returns the modeled spill
        seconds, or ``None`` when already at the degradation floor
        (``min_device_fraction`` × the hardware capacity) — the caller
        should then give up and surface the OOM."""
        floor = self.hw.device_capacity * self.min_device_fraction
        cur = self.capacity[Tier.DEVICE]
        new_cap = max(floor, cur * self.degrade_factor)
        if new_cap >= cur:
            return None
        self.capacity[Tier.DEVICE] = new_cap
        self._stat["oom_demotions"].inc()
        self._event("degrade", new_capacity=new_cap)
        cost = 0.0
        while self.used[Tier.DEVICE] > new_cap:
            victim_key = self._victim_key(Tier.DEVICE)
            if victim_key is None:
                break  # everything pinned; pressure persists but we tried
            cost += self._demote(self.chunks[victim_key])
            self._stat["evictions"].inc()
        return cost

    # -- introspection --------------------------------------------------------------

    def tier_of(self, key: tuple[str, int]) -> Tier:
        return self.chunks[key].tier

    def device_bytes(self) -> float:
        return self.used[Tier.DEVICE]

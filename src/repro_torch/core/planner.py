"""Lightning's execution planner (paper §2.4).

For every distributed kernel launch the planner:

1. splits the launch grid into superblocks (``WorkDistribution``);
2. evaluates the kernel's data annotation per superblock → *access regions*;
3. queries each argument's chunk distribution for intersecting chunks;
4. classifies the argument into a :class:`CommPattern` and emits the
   data-movement tasks (Copy/Send/Recv/Gather/Reduce) into the task DAG;
5. adds cross-launch dependency edges on chunk conflicts (write-read,
   write-write, read-write) so the asynchronous execution stays sequentially
   consistent (paper cites Lamport [21]).

The same classification drives the launcher: LOCAL → no
communication, HALO → neighbour edge exchange, GATHER → all-gather, REDUCE →
partials combined by a hierarchical (device → node → global) reduction,
SCATTER → temp chunk + scatter.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Sequence

from .annotations import Annotation, REDUCE, WRITE
from .distributions import Chunk, CustomDist, Distribution, ReplicatedDist
from .ndrange import Region
from .plan_ir import (
    ArgPlan,
    ChunkRef,
    CommPattern,
    ExecutionPlan,
    LaunchPlan,
    PlanTemplate,
    Task,
    TaskKind,
)
from .superblock import Superblock, WorkDistribution


@dataclasses.dataclass(frozen=True)
class ArrayMeta:
    """What the planner needs to know about one distributed array."""

    name: str
    shape: tuple[int, ...]
    dtype_size: int
    dist: Distribution

    @property
    def nbytes(self) -> int:
        return math.prod(self.shape) * self.dtype_size


@dataclasses.dataclass
class ChunkState:
    """Version/conflict bookkeeping for sequential consistency."""

    last_writer: int | None = None  # task id
    readers_since_write: list[int] = dataclasses.field(default_factory=list)
    version: int = 0


class ChunkStateTable:
    """Tracks, per (array, chunk), the last writer and readers across
    launches.  The planner consults it to add conflict edges — this is how
    consecutive asynchronous launches are stitched into one large DAG."""

    def __init__(self) -> None:
        self._state: dict[tuple[str, int], ChunkState] = {}
        # When a list, every note_read/note_write appends ("read"/"write",
        # ref, tid) — the planner records a launch into a fresh table this
        # way to build a reusable PlanTemplate.
        self.note_log: list[tuple[str, ChunkRef, int]] | None = None

    def state(self, ref: ChunkRef) -> ChunkState:
        return self._state.setdefault(ref.key(), ChunkState())

    def read_deps(self, ref: ChunkRef) -> list[int]:
        st = self.state(ref)
        return [st.last_writer] if st.last_writer is not None else []

    def write_deps(self, ref: ChunkRef) -> list[int]:
        st = self.state(ref)
        deps = list(st.readers_since_write)
        if st.last_writer is not None:
            deps.append(st.last_writer)
        return deps

    def note_read(self, ref: ChunkRef, tid: int) -> None:
        self.state(ref).readers_since_write.append(tid)
        if self.note_log is not None:
            self.note_log.append(("read", ref, tid))

    def note_write(self, ref: ChunkRef, tid: int) -> None:
        st = self.state(ref)
        st.last_writer = tid
        st.readers_since_write = []
        st.version += 1
        if self.note_log is not None:
            self.note_log.append(("write", ref, tid))

    # -- lineage lookups (fault recovery) -----------------------------------

    def keys(self) -> list[tuple[str, int]]:
        return list(self._state)

    def last_writer_of(self, key: tuple[str, int]) -> int | None:
        """The task id that produced the current version of ``key``, if any
        — the recovery engine's first stop when a chunk is lost."""
        st = self._state.get(key)
        return st.last_writer if st is not None else None


@dataclasses.dataclass(frozen=True)
class Topology:
    """Devices grouped into nodes (pods).  Flat device ids are contiguous per
    node: node(d) = d // devices_per_node."""

    num_devices: int
    devices_per_node: int = 4

    def node(self, device: int) -> int:
        return device // self.devices_per_node

    def same_node(self, a: int, b: int) -> bool:
        return self.node(a) == self.node(b)

    @property
    def num_nodes(self) -> int:
        return math.ceil(self.num_devices / self.devices_per_node)


class Planner:
    """Builds :class:`LaunchPlan`s and stitches them via a shared
    :class:`ChunkStateTable`."""

    def __init__(
        self,
        topology: Topology,
        registry=None,
        cache_plans: bool = True,
        cache_capacity: int = 128,
        placement: str = "owner",
    ):
        if placement not in ("owner", "locality"):
            raise ValueError(f"unknown placement policy {placement!r}")
        self.topology = topology
        # Task placement: "owner" keeps each superblock on the worker the
        # work distribution assigned (the original behaviour);
        # "locality" re-homes a superblock onto the worker already holding
        # the largest share of its input bytes, eliminating the staging
        # traffic the default placement would pay.  Re-homed superblocks
        # count under ``place.affinity_hits``; templates record the final
        # owners, so cached replays keep the affinity.
        self.placement = placement
        self.chunk_state = ChunkStateTable()
        # Plan cache: signature → PlanTemplate, LRU-bounded.  Repeated
        # launches (the steady state of training/serving loops) skip
        # re-planning and instantiate the memoized template instead.
        self.cache_plans = cache_plans
        self._registry = registry
        self._plan_cache: dict[tuple, PlanTemplate] = {}
        self._cache_capacity = cache_capacity

    def _cache_counter(self, result: str):
        # Lazy resolve so ``use_registry`` redirects us too.
        from ..obs.metrics import default_registry

        reg = self._registry if self._registry is not None \
            else default_registry()
        return reg.counter(
            "plan.cache", help="plan-cache lookups by result"
        ).labels(result=result)

    def _affinity_counter(self):
        from ..obs.metrics import default_registry

        reg = self._registry if self._registry is not None \
            else default_registry()
        return reg.counter(
            "place.affinity_hits",
            help="superblocks re-homed onto the max-input-affinity worker",
        )

    # -- main entry point ------------------------------------------------------

    def plan_launch(
        self,
        name: str,
        annotation: Annotation,
        grid: Sequence[int],
        work_dist: WorkDistribution,
        arrays: Mapping[str, ArrayMeta],
        block_shape: Sequence[int] | None = None,
        plan: ExecutionPlan | None = None,
        cache: bool | None = None,
    ) -> LaunchPlan:
        grid = tuple(int(g) for g in grid)
        if plan is None:
            # Standalone plan: task ids restart at 0, so cross-launch chunk
            # state (which stores task ids) must reset too.  Callers that
            # want launch stitching (sequential consistency across launches)
            # pass one shared ExecutionPlan — e.g. Context does.
            plan = ExecutionPlan(launch_name=name)
            self.chunk_state = ChunkStateTable()
        use_cache = self.cache_plans if cache is None else cache
        if not use_cache:
            return self._plan_native(name, annotation, grid, work_dist,
                                     arrays, block_shape, plan)
        sig = self._plan_signature(name, annotation, grid, work_dist, arrays,
                                   block_shape)
        if sig is None:
            self._cache_counter("uncacheable").inc()
            return self._plan_native(name, annotation, grid, work_dist,
                                     arrays, block_shape, plan)
        tmpl = self._plan_cache.pop(sig, None)
        if tmpl is not None:
            self._cache_counter("hit").inc()
        else:
            self._cache_counter("miss").inc()
            tmpl = self._build_template(name, annotation, grid, work_dist,
                                        arrays, block_shape)
        self._plan_cache[sig] = tmpl  # (re-)insert at LRU tail
        while len(self._plan_cache) > self._cache_capacity:
            self._plan_cache.pop(next(iter(self._plan_cache)))
        return self._instantiate(tmpl, plan)

    def _plan_native(
        self,
        name: str,
        annotation: Annotation,
        grid: tuple[int, ...],
        work_dist: WorkDistribution,
        arrays: Mapping[str, ArrayMeta],
        block_shape: Sequence[int] | None,
        plan: ExecutionPlan,
    ) -> LaunchPlan:
        nd = self.topology.num_devices
        superblocks = work_dist.superblocks(grid, nd)
        if self.placement == "locality":
            superblocks = [
                self._rehome(sb, annotation, arrays, block_shape, nd)
                for sb in superblocks
            ]

        # Classify every argument once (patterns are superblock-uniform for
        # the distributions we ship; per-superblock deviations fall back to
        # GATHER/SCATTER which are always correct — paper §2.4: distributions
        # affect performance, not correctness).
        arg_plans = [
            self._classify_arg(annotation, stmt_array, grid, superblocks,
                               arrays, block_shape)
            for stmt_array in annotation.arrays()
        ]
        arg_by_name = {a.array: a for a in arg_plans}

        # Emit tasks per superblock.
        reduce_partials: dict[str, list[Task]] = {}
        for sb in superblocks:
            env = annotation.env_for_superblock(sb, block_shape=block_shape)
            exec_deps: list[int] = []
            exec_reads: list[ChunkRef] = []
            exec_writes: list[ChunkRef] = []

            for stmt in annotation.stmts:
                meta = arrays[stmt.array]
                region = stmt.region(env, meta.shape)
                chunks = meta.dist.query(region, meta.shape, nd)
                ap = arg_by_name[stmt.array]

                if stmt.mode == REDUCE:
                    # Temp chunk for block-level partials (paper: "the planner
                    # handles reduce accesses separately").
                    tmp = ChunkRef(stmt.array, 10_000 + sb.index, temp=True)
                    t = plan.add(
                        TaskKind.CREATE_CHUNK,
                        sb.owner,
                        bytes=region.volume * meta.dtype_size,
                        writes=[tmp],
                        region=region,
                        label=f"partial:{stmt.array}",
                    )
                    exec_deps.append(t.tid)
                    exec_writes.append(tmp)
                    reduce_partials.setdefault(stmt.array, [])
                    continue

                if stmt.reads:
                    deps, refs, moved = self._stage_reads(
                        plan, sb, region, meta, chunks
                    )
                    exec_deps.extend(deps)
                    exec_reads.extend(refs)
                if stmt.writes:
                    local = [c for c in chunks if c.owner == sb.owner]
                    targets = local if local else chunks
                    for c in targets:
                        ref = ChunkRef(stmt.array, c.index)
                        exec_deps.extend(self.chunk_state.write_deps(ref))
                        exec_writes.append(ref)

            et = plan.add(
                TaskKind.EXECUTE,
                sb.owner,
                deps=sorted(set(exec_deps)),
                reads=exec_reads,
                writes=exec_writes,
                superblock=sb.index,
                region=sb.threads,
                flops=sb.threads.volume,
                label=name,
            )
            for ref in exec_reads:
                if not ref.temp:
                    self.chunk_state.note_read(ref, et.tid)
            for ref in exec_writes:
                if not ref.temp:
                    self.chunk_state.note_write(ref, et.tid)
            for arr in reduce_partials:
                reduce_partials[arr].append(et)

            # Post-write replica sync for overlapping distributions.
            for stmt in annotation.stmts:
                meta = arrays[stmt.array]
                if stmt.mode == WRITE and meta.dist.halo is not None:
                    plan.add(
                        TaskKind.SYNC_REPLICAS,
                        sb.owner,
                        deps=[et.tid],
                        bytes=self._halo_bytes(meta),
                        label=f"halo:{stmt.array}",
                    )

        # Hierarchical reduction trees (superblock → device → node → root).
        for arr, partial_execs in reduce_partials.items():
            stmt = annotation.stmt_for(arr)
            self._emit_reduction_tree(
                plan, arrays[arr], stmt.reduce_op or "+", partial_execs
            )

        plan.validate()
        return LaunchPlan(
            name=name,
            plan=plan,
            args=tuple(arg_plans),
            num_superblocks=len(superblocks),
            grid=grid,
        )

    # -- locality-aware placement ----------------------------------------------

    def _rehome(
        self,
        sb: Superblock,
        annotation: Annotation,
        arrays: Mapping[str, ArrayMeta],
        block_shape: Sequence[int] | None,
        nd: int,
    ) -> Superblock:
        """Re-home one superblock onto the worker already holding the
        largest share of its input bytes (Gunrock-style locality-aware
        placement): staging that data is the dominant cost, so the task
        should move to the data rather than the other way around.  The
        incumbent owner wins ties, so aligned layouts are untouched."""
        share: dict[int, int] = {}
        env = annotation.env_for_superblock(sb, block_shape=block_shape)
        for stmt in annotation.stmts:
            if not stmt.reads or stmt.mode == REDUCE:
                continue
            meta = arrays[stmt.array]
            region = stmt.region(env, meta.shape)
            for c in meta.dist.query(region, meta.shape, nd):
                part = (c.interior or c.region).intersect(region)
                if not part.is_empty:
                    share[c.owner] = (share.get(c.owner, 0)
                                      + part.volume * meta.dtype_size)
        if not share:
            return sb
        best_bytes = max(share.values())
        if share.get(sb.owner, 0) >= best_bytes:
            return sb  # incumbent already holds the largest share
        best = min(w for w, b in share.items() if b == best_bytes)
        self._affinity_counter().inc()
        return dataclasses.replace(sb, owner=best)

    # -- plan caching ----------------------------------------------------------

    def _plan_signature(
        self,
        name: str,
        annotation: Annotation,
        grid: tuple[int, ...],
        work_dist: WorkDistribution,
        arrays: Mapping[str, ArrayMeta],
        block_shape: Sequence[int] | None,
    ) -> tuple | None:
        """Stable cache key covering every planning input, or ``None`` when a
        component can't be signed (``CustomDist`` wraps arbitrary callables;
        non-dataclass distributions have address-based reprs that could
        collide after GC)."""
        if not dataclasses.is_dataclass(work_dist):
            return None
        for meta in arrays.values():
            if isinstance(meta.dist, CustomDist) \
                    or not dataclasses.is_dataclass(meta.dist):
                return None
        src = getattr(annotation, "source", "")
        if not src:
            return None
        return (
            name,
            src,
            grid,
            repr(work_dist),
            tuple(block_shape) if block_shape is not None else None,
            (self.topology.num_devices, self.topology.devices_per_node),
            self.placement,
            tuple(sorted(
                (arg, m.name, m.shape, m.dtype_size, repr(m.dist))
                for arg, m in arrays.items()
            )),
        )

    def _build_template(
        self,
        name: str,
        annotation: Annotation,
        grid: tuple[int, ...],
        work_dist: WorkDistribution,
        arrays: Mapping[str, ArrayMeta],
        block_shape: Sequence[int] | None,
    ) -> PlanTemplate:
        """Plan natively into a private plan against a fresh recording
        chunk-state table: task ids start at 0 and deps capture only
        intra-launch structure, so the result replays into any shared plan."""
        saved = self.chunk_state
        tmpl_plan = ExecutionPlan(launch_name=name)
        recording = ChunkStateTable()
        recording.note_log = []
        self.chunk_state = recording
        try:
            lp = self._plan_native(name, annotation, grid, work_dist, arrays,
                                   block_shape, tmpl_plan)
        finally:
            self.chunk_state = saved
        return PlanTemplate(
            name=name,
            tasks=tuple(tmpl_plan.tasks),
            note_log=tuple(recording.note_log),
            args=lp.args,
            num_superblocks=lp.num_superblocks,
            grid=lp.grid,
        )

    def _instantiate(self, tmpl: PlanTemplate,
                     plan: ExecutionPlan) -> LaunchPlan:
        """Replay a template into ``plan``: re-number tasks, add cross-launch
        conflict edges from the live chunk-state table, and re-emit the
        recorded notes so subsequent launches stitch against this one exactly
        as they would against a natively-planned launch."""
        notes_by_tid: dict[int, list[tuple[str, ChunkRef]]] = {}
        for op, ref, tid in tmpl.note_log:
            notes_by_tid.setdefault(tid, []).append((op, ref))
        remap: dict[int, int] = {}
        for tt in tmpl.tasks:
            base = [remap[d] for d in tt.deps]
            base_set = set(base)
            extra: set[int] = set()
            for ref in tt.reads:
                if not ref.temp:
                    extra.update(d for d in self.chunk_state.read_deps(ref)
                                 if d not in base_set)
            for ref in tt.writes:
                if not ref.temp:
                    extra.update(d for d in self.chunk_state.write_deps(ref)
                                 if d not in base_set)
            # Native dep order is preserved when the live table adds nothing;
            # with cross-launch extras the merged set is sorted — which is
            # exactly what native planning emits (EXECUTE deps are
            # sorted(set(...)); staging deps put the earlier-tid writer
            # first).
            deps = sorted(base_set | extra) if extra else base
            nt = plan.add_from(tt, deps)
            remap[tt.tid] = nt.tid
            for op, ref in notes_by_tid.get(tt.tid, ()):
                if op == "read":
                    self.chunk_state.note_read(ref, nt.tid)
                else:
                    self.chunk_state.note_write(ref, nt.tid)
        plan.validate()
        return LaunchPlan(
            name=tmpl.name,
            plan=plan,
            args=tmpl.args,
            num_superblocks=tmpl.num_superblocks,
            grid=tmpl.grid,
        )

    # -- argument classification ----------------------------------------------

    def _classify_arg(
        self,
        annotation: Annotation,
        array: str,
        grid: tuple[int, ...],
        superblocks: Sequence[Superblock],
        arrays: Mapping[str, ArrayMeta],
        block_shape: Sequence[int] | None,
    ) -> ArgPlan:
        stmt = annotation.stmt_for(array)
        meta = arrays[array]
        nd = self.topology.num_devices

        if stmt.mode == REDUCE:
            pass  # reduce wins over storage: partials + tree regardless
        elif isinstance(meta.dist, ReplicatedDist) or meta.dist.replicated:
            # Reads are free; writes need a replica broadcast.
            comm = meta.nbytes * (nd - 1) if stmt.writes else 0
            return ArgPlan(array, CommPattern.REPLICATED, stmt.mode,
                           stmt.reduce_op, comm_bytes=comm,
                           note="replicated distribution")

        if stmt.mode == REDUCE:
            # log-tree over devices on the partial region size.
            env0 = annotation.env_for_superblock(superblocks[0], block_shape)
            region0 = stmt.region(env0, meta.shape)
            comm = region0.volume * meta.dtype_size * max(
                1, int(math.log2(max(2, nd)))
            )
            return ArgPlan(array, CommPattern.REDUCE, stmt.mode, stmt.reduce_op,
                           comm_bytes=comm)

        # Inspect the relationship between access regions and owned chunks.
        worst = CommPattern.LOCAL
        halo: tuple[int, ...] | None = None
        comm_bytes = 0
        for sb in superblocks:
            env = annotation.env_for_superblock(sb, block_shape=block_shape)
            region = stmt.region(env, meta.shape)
            chunks = meta.dist.query(region, meta.shape, nd)
            local = [c for c in chunks if c.owner == sb.owner]
            if any((c.interior or c.region).contains(region) for c in local):
                continue  # fits in the owned interior: no communication
            if meta.dist.halo is not None and any(
                c.region.contains(region) for c in local
            ):
                # Fits in the haloed chunk but not the interior: workers
                # store interiors only, so this is a halo
                # exchange (the simulator's SYNC_REPLICAS carries the same
                # bytes).
                h = meta.dist.halo
                worst = _max_pattern(worst, CommPattern.HALO)
                if halo is None:
                    halo = h
                else:
                    n_ax = max(len(halo), len(h))
                    pa = tuple(halo) + (0,) * (n_ax - len(halo))
                    pb = tuple(h) + (0,) * (n_ax - len(h))
                    halo = tuple(max(a, b) for a, b in zip(pa, pb))
                comm_bytes += self._halo_bytes(meta) // max(1, len(superblocks))
                continue
            enclosing = meta.dist.find_enclosing(region, meta.shape, nd)
            if enclosing is not None and len(chunks) <= 2 and local:
                # Region = local chunk extended by a bounded shift → halo.
                own = local[0].interior or local[0].region
                h = tuple(
                    max(own.intervals[d][0] - region.intervals[d][0],
                        region.intervals[d][1] - own.intervals[d][1], 0)
                    for d in range(region.ndim)
                )
                if max(h, default=0) * 4 <= min(
                    (own.shape[d] for d in range(own.ndim) if h[d]), default=1
                ) or meta.dist.halo is not None:
                    worst = _max_pattern(worst, CommPattern.HALO)
                    halo = h if halo is None else tuple(map(max, halo, h))
                    comm_bytes += (
                        region.volume - region.intersect(own).volume
                    ) * meta.dtype_size
                    continue
            # Fallback: temp-chunk assembly == gather (always correct).
            if stmt.writes and not stmt.reads:
                worst = _max_pattern(worst, CommPattern.SCATTER)
            else:
                worst = _max_pattern(worst, CommPattern.GATHER)
            remote = [c for c in chunks if c.owner != sb.owner]
            comm_bytes += sum(
                c.region.intersect(region).volume for c in remote
            ) * meta.dtype_size
        return ArgPlan(array, worst, stmt.mode, stmt.reduce_op,
                       halo_width=halo, comm_bytes=comm_bytes)

    # -- read staging -----------------------------------------------------------

    def _stage_reads(
        self,
        plan: ExecutionPlan,
        sb: Superblock,
        region: Region,
        meta: ArrayMeta,
        chunks: Sequence[Chunk],
    ) -> tuple[list[int], list[ChunkRef], int]:
        """Make ``region`` of ``meta`` available on ``sb.owner``; returns
        (deps for the execute task, chunk refs read, bytes moved)."""
        deps: list[int] = []
        refs: list[ChunkRef] = []
        moved = 0
        local_enclosing = [
            c for c in chunks
            if c.owner == sb.owner and c.region.contains(region)
        ]
        if local_enclosing:
            ref = ChunkRef(meta.name, local_enclosing[0].index)
            deps.extend(self.chunk_state.read_deps(ref))
            refs.append(ref)
            return deps, refs, 0

        remote_enclosing = [c for c in chunks if c.region.contains(region)]
        if remote_enclosing:
            # Single remote chunk: Copy (same node) or Send+Recv (cross node).
            src = remote_enclosing[0]
            src_ref = ChunkRef(meta.name, src.index)
            tmp = ChunkRef(meta.name, 20_000 + sb.index, temp=True)
            nbytes = region.volume * meta.dtype_size
            rdeps = self.chunk_state.read_deps(src_ref)
            if self.topology.same_node(src.owner, sb.owner):
                t = plan.add(TaskKind.COPY, src.owner, deps=rdeps,
                             reads=[src_ref], writes=[tmp], region=region,
                             bytes=nbytes, peer=sb.owner,
                             label=f"p2p:{meta.name}")
                deps.append(t.tid)
            else:
                s = plan.add(TaskKind.SEND, src.owner, deps=rdeps,
                             reads=[src_ref], region=region, bytes=nbytes,
                             peer=sb.owner, label=f"send:{meta.name}")
                r = plan.add(TaskKind.RECV, sb.owner, deps=[s.tid],
                             writes=[tmp], region=region, bytes=nbytes,
                             peer=src.owner, label=f"recv:{meta.name}")
                deps.append(r.tid)
            self.chunk_state.note_read(src_ref, deps[-1])
            refs.append(tmp)
            return deps, refs, nbytes

        # Exceptional case (paper Fig. 2c): assemble a temp chunk from all
        # intersecting chunks.
        tmp = ChunkRef(meta.name, 30_000 + sb.index, temp=True)
        ct = plan.add(TaskKind.CREATE_CHUNK, sb.owner, writes=[tmp],
                      region=region, bytes=region.volume * meta.dtype_size,
                      label=f"assemble:{meta.name}")
        gather_deps = [ct.tid]
        for c in chunks:
            part = c.region.intersect(region)
            if part.is_empty:
                continue
            src_ref = ChunkRef(meta.name, c.index)
            nbytes = part.volume * meta.dtype_size
            rdeps = self.chunk_state.read_deps(src_ref) + [ct.tid]
            if c.owner == sb.owner:
                t = plan.add(TaskKind.COPY, c.owner, deps=rdeps,
                             reads=[src_ref], writes=[tmp], region=part,
                             bytes=nbytes, peer=sb.owner,
                             label=f"gather:{meta.name}")
                gather_deps.append(t.tid)
            elif self.topology.same_node(c.owner, sb.owner):
                t = plan.add(TaskKind.COPY, c.owner, deps=rdeps,
                             reads=[src_ref], writes=[tmp], region=part,
                             bytes=nbytes, peer=sb.owner,
                             label=f"gather:{meta.name}")
                gather_deps.append(t.tid)
                moved += nbytes
            else:
                s = plan.add(TaskKind.SEND, c.owner, deps=rdeps,
                             reads=[src_ref], region=part, bytes=nbytes,
                             peer=sb.owner, label=f"gather-send:{meta.name}")
                r = plan.add(TaskKind.RECV, sb.owner, deps=[s.tid],
                             writes=[tmp], region=part, bytes=nbytes,
                             peer=c.owner, label=f"gather-recv:{meta.name}")
                gather_deps.append(r.tid)
                moved += nbytes
            self.chunk_state.note_read(src_ref, gather_deps[-1])
        deps.extend(gather_deps)
        refs.append(tmp)
        return deps, refs, moved

    # -- reductions --------------------------------------------------------------

    def _emit_reduction_tree(
        self,
        plan: ExecutionPlan,
        meta: ArrayMeta,
        op: str,
        partial_execs: Sequence[Task],
    ) -> None:
        """Hierarchical reduction: superblock partials → per-device → per-node
        → global root, then broadcast/scatter into the owning chunks (paper:
        "first the results for one superblock, then for one GPU, then for each
        node, and finally ... across all nodes")."""
        level = [(t.worker, t.tid) for t in partial_execs]
        nbytes = meta.nbytes  # partial result has the output's region size

        def reduce_group(items: list[tuple[int, int]], home: int) -> tuple[int, int]:
            deps = [tid for _, tid in items]
            t = plan.add(TaskKind.REDUCE, home, deps=deps, reduce_op=op,
                         bytes=nbytes * max(0, len(items) - 1),
                         label=f"reduce:{meta.name}")
            return (home, t.tid)

        # per-device
        by_dev: dict[int, list[tuple[int, int]]] = {}
        for w, tid in level:
            by_dev.setdefault(w, []).append((w, tid))
        level = [reduce_group(v, d) for d, v in sorted(by_dev.items())]
        # per-node
        by_node: dict[int, list[tuple[int, int]]] = {}
        for w, tid in level:
            by_node.setdefault(self.topology.node(w), []).append((w, tid))
        lvl2 = []
        for node, items in sorted(by_node.items()):
            home = items[0][0]
            if len(items) > 1:
                for w, tid in items[1:]:
                    s = plan.add(TaskKind.COPY, w, deps=[tid], bytes=nbytes,
                                 peer=home, label=f"reduce-move:{meta.name}")
                    items[items.index((w, tid))] = (w, s.tid)
                lvl2.append(reduce_group(items, home))
            else:
                lvl2.append(items[0])
        # across nodes
        if len(lvl2) > 1:
            root = lvl2[0][0]
            staged = [lvl2[0]]
            for w, tid in lvl2[1:]:
                s = plan.add(TaskKind.SEND, w, deps=[tid], bytes=nbytes,
                             peer=root, label=f"reduce-send:{meta.name}")
                r = plan.add(TaskKind.RECV, root, deps=[s.tid], bytes=nbytes,
                             peer=w, label=f"reduce-recv:{meta.name}")
                staged.append((root, r.tid))
            reduce_group(staged, root)

    # -- misc ---------------------------------------------------------------------

    def _halo_bytes(self, meta: ArrayMeta) -> int:
        h = meta.dist.halo
        if not h:
            return 0
        per_axis = 0
        for ax, width in enumerate(h):
            if width:
                cross = math.prod(
                    s for i, s in enumerate(meta.shape) if i != ax
                )
                per_axis += 2 * width * cross * meta.dtype_size
        return per_axis


_ORDER = [
    CommPattern.LOCAL,
    CommPattern.HALO,
    CommPattern.SCATTER,
    CommPattern.GATHER,
]


def _max_pattern(a: CommPattern, b: CommPattern) -> CommPattern:
    ia = _ORDER.index(a) if a in _ORDER else len(_ORDER)
    ib = _ORDER.index(b) if b in _ORDER else len(_ORDER)
    return a if ia >= ib else b

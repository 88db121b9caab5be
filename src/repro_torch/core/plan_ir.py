"""Task-DAG intermediate representation for execution plans (paper §2.4).

An execution plan is a DAG of small tasks per worker: execute a kernel on a
superblock, create/delete a chunk, copy data between chunks, send/recv chunks
between nodes, and reduce partial results.  The planner builds one such DAG
per distributed kernel launch and stitches consecutive launches together with
chunk-conflict dependency edges (sequential consistency).

Two consumers:
* a discrete-event scheduler executes plans against the memory-manager
  cost model (reproduces the paper's Figs. 10–12 behaviour);
* the launcher (:mod:`repro_torch.core.launch`) reads the plan's
  per-argument communication pattern to decide what each argument needs.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Iterator, Sequence

from .ndrange import Region


class TaskKind(enum.Enum):
    CREATE_CHUNK = "create_chunk"
    DELETE_CHUNK = "delete_chunk"
    COPY = "copy"  # intra-node chunk-to-chunk copy (P2P DMA / NVLink peer)
    SEND = "send"  # inter-node (network) send
    RECV = "recv"  # inter-node (network) recv
    EXECUTE = "execute"  # run one superblock's kernel on a device
    REDUCE = "reduce"  # combine partial chunks (one level of the tree)
    SYNC_REPLICAS = "sync_replicas"  # refresh overlapping/halo replicas


@dataclasses.dataclass(frozen=True)
class ChunkRef:
    """Reference to a chunk instance: (array, chunk index, version)."""

    array: str
    chunk: int
    version: int = 0
    temp: bool = False  # planner-created temporary (assembled/partial chunk)

    def key(self) -> tuple[str, int]:
        return (self.array, self.chunk)


@dataclasses.dataclass
class Task:
    tid: int
    kind: TaskKind
    worker: int  # device that executes this task
    deps: list[int] = dataclasses.field(default_factory=list)
    # Payload (interpretation depends on kind):
    reads: list[ChunkRef] = dataclasses.field(default_factory=list)
    writes: list[ChunkRef] = dataclasses.field(default_factory=list)
    region: Region | None = None  # data region moved / computed over
    superblock: int | None = None  # EXECUTE: which superblock
    peer: int | None = None  # SEND/RECV: the other device
    reduce_op: str | None = None  # REDUCE
    bytes: int = 0  # payload size (for the cost model)
    flops: int = 0  # EXECUTE cost model input
    label: str = ""

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"Task#{self.tid}({self.kind.value}@w{self.worker}"
            + (f" sb{self.superblock}" if self.superblock is not None else "")
            + (f" deps={self.deps}" if self.deps else "")
            + (f" {self.label}" if self.label else "")
            + ")"
        )


@dataclasses.dataclass
class ExecutionPlan:
    """A DAG of tasks spanning all workers, for one (or more) launches."""

    tasks: list[Task] = dataclasses.field(default_factory=list)
    launch_name: str = ""

    # -- construction ---------------------------------------------------------

    def add(
        self,
        kind: TaskKind,
        worker: int,
        deps: Sequence[int] = (),
        **kw,
    ) -> Task:
        t = Task(tid=len(self.tasks), kind=kind, worker=worker, deps=list(deps), **kw)
        self.tasks.append(t)
        return t

    def merge(self, other: "ExecutionPlan") -> dict[int, int]:
        """Append ``other``'s tasks (re-numbered); returns old→new tid map."""
        remap: dict[int, int] = {}
        for t in other.tasks:
            nt = dataclasses.replace(
                t, tid=len(self.tasks), deps=[remap[d] for d in t.deps]
            )
            remap[t.tid] = nt.tid
            self.tasks.append(nt)
        return remap

    def add_from(self, template_task: Task, deps: Sequence[int]) -> Task:
        """Append a re-numbered copy of a :class:`PlanTemplate` task.  List
        payloads are copied so the cached template stays immutable."""
        nt = dataclasses.replace(
            template_task,
            tid=len(self.tasks),
            deps=list(deps),
            reads=list(template_task.reads),
            writes=list(template_task.writes),
        )
        self.tasks.append(nt)
        return nt

    # -- analysis -------------------------------------------------------------

    def by_worker(self, worker: int) -> list[Task]:
        return [t for t in self.tasks if t.worker == worker]

    def workers(self) -> list[int]:
        return sorted({t.worker for t in self.tasks})

    def validate(self) -> None:
        """Check the DAG is well-formed and acyclic (topological order by id:
        the planner always emits dependencies on earlier tasks)."""
        seen: set[int] = set()
        for t in self.tasks:
            for d in t.deps:
                if d not in seen:
                    raise ValueError(
                        f"task {t.tid} depends on {d} which is not an earlier task"
                    )
            seen.add(t.tid)

    def toposort(self) -> Iterator[Task]:
        self.validate()
        return iter(self.tasks)

    def counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for t in self.tasks:
            out[t.kind.value] = out.get(t.kind.value, 0) + 1
        return out

    def comm_bytes(self) -> dict[str, int]:
        """Total bytes moved, split into intra-node copies vs inter-node."""
        intra = sum(t.bytes for t in self.tasks if t.kind is TaskKind.COPY)
        inter = sum(t.bytes for t in self.tasks if t.kind is TaskKind.SEND)
        return {"intra_node": intra, "inter_node": inter}

    def critical_path_tasks(self) -> int:
        """Length (in tasks) of the longest dependency chain."""
        depth: dict[int, int] = {}
        for t in self.tasks:
            depth[t.tid] = 1 + max((depth[d] for d in t.deps), default=0)
        return max(depth.values(), default=0)

    # -- lineage (fault recovery) ---------------------------------------------

    def producers_of(self, key: tuple[str, int]) -> list[int]:
        """Task ids that write chunk ``key``, in plan order.  The recovery
        engine replays the latest *finished* producer to recompute a chunk
        lost with a dead worker (lineage replay)."""
        return [t.tid for t in self.tasks
                if any(ref.key() == key for ref in t.writes)]

    def readers_of(self, key: tuple[str, int]) -> list[int]:
        """Task ids that read chunk ``key``, in plan order."""
        return [t.tid for t in self.tasks
                if any(ref.key() == key for ref in t.reads)]

    def reads_index(self) -> dict[tuple[str, int], list[int]]:
        """Chunk key → reader task ids, in plan order — the whole-plan view
        ``readers_of`` gives one key at a time.  The scheduler's multicast
        stager uses it to find every worker that will consume a chunk."""
        idx: dict[tuple[str, int], list[int]] = {}
        for t in self.tasks:
            for ref in t.reads:
                idx.setdefault(ref.key(), []).append(t.tid)
        return idx


# ---------------------------------------------------------------------------
# Communication patterns recognized by the launcher
# ---------------------------------------------------------------------------


class CommPattern(enum.Enum):
    """How one kernel argument's access region relates to its distribution.

    The planner classifies every (argument × work-distribution) pair into one
    of these; ``launch.py`` maps each to the corresponding data movement.
    """

    LOCAL = "local"  # region ⊆ locally-owned chunk: no communication
    HALO = "halo"  # region = local chunk ± bounded shift: edge exchange
    GATHER = "gather"  # region spans remote chunks: gather / temp assembly
    SCATTER = "scatter"  # multi-chunk write: temp + scatter
    REDUCE = "reduce"  # reduce(f) access: partials + hierarchical reduction
    REPLICATED = "replicated"  # distribution is replicated: read free / write sync


@dataclasses.dataclass(frozen=True)
class ArgPlan:
    """Planner verdict for one kernel argument."""

    array: str
    pattern: CommPattern
    mode: str  # read/write/readwrite/reduce
    reduce_op: str | None = None
    halo_width: tuple[int, ...] | None = None  # per-axis, for HALO
    comm_bytes: int = 0  # planner's estimate of bytes this arg moves
    note: str = ""


@dataclasses.dataclass(frozen=True)
class PlanTemplate:
    """Position-independent recording of one launch's planning, built against
    a fresh :class:`~repro_torch.core.planner.ChunkStateTable` so task ids start at
    0 and deps capture only intra-launch structure.  The planner instantiates
    a template into any shared plan by re-numbering tasks, re-consulting the
    live chunk-state table for cross-launch conflict edges, and re-emitting
    the recorded read/write notes — the memoized fast path for the
    repeated-launch steady state of training/serving loops."""

    name: str
    tasks: tuple[Task, ...]
    # (op, ref, template_tid) with op in {"read", "write"}; every note with
    # tid T was recorded immediately after task T was added, so replay emits
    # T's notes right after instantiating T and the table evolves exactly as
    # it would under native planning.
    note_log: tuple[tuple[str, ChunkRef, int], ...]
    args: tuple["ArgPlan", ...]
    num_superblocks: int
    grid: tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """Full planner output for one distributed kernel launch."""

    name: str
    plan: ExecutionPlan
    args: tuple[ArgPlan, ...]
    num_superblocks: int
    grid: tuple[int, ...]

    def arg(self, name: str) -> ArgPlan:
        for a in self.args:
            if a.array == name:
                return a
        raise KeyError(name)

    def total_comm_bytes(self) -> int:
        return sum(a.comm_bytes for a in self.args)

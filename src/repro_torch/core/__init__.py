"""Lightning's core abstractions on PyTorch.

Public API (mirrors the paper's host-code surface, Fig. 9):

* :class:`~repro_torch.core.launch.Context` — the host runtime: array
  factory + launches
* :class:`~repro_torch.core.launch.KernelDef` — annotated kernel definitions
* distributions — :class:`BlockDist`, :class:`RowDist`, :class:`ColDist`,
  :class:`TileDist`, :class:`StencilDist`, :class:`ReplicatedDist`
* work distributions — :class:`BlockWork`, :class:`EvenWork`,
  :class:`TileWork`, :class:`MeshWork`
* :func:`~repro_torch.core.annotations.parse` — the data-annotation DSL
* :class:`~repro_torch.core.mesh.Mesh`, :func:`make_mesh` — workers with
  named axes, and :func:`collective_reduce`, the combine across them; on
  a rank mesh (``Context(mesh=<DeviceMesh>)``, one ``torch.distributed``
  rank a worker, each holding only its shards) its rank form
  :func:`collective_reduce_ranks`, and :func:`is_rank_mesh`,
  :func:`mesh_shape`, :func:`mesh_size`, :func:`mesh_coords`, the one
  surface both kinds of mesh share
* the paper's runtime model: :class:`MemoryManager` (per-worker LRU
  spilling across device, host and disk, §3.4) and :class:`Simulator`
  (the discrete-event scheduler with staging throttle, prefetch, the d2d
  fabric and fault recovery, §3.3), costed by :class:`HardwareModel`
  (an NVIDIA H100 by default)
"""

from .annotations import Annotation, AnnotationError, parse
from .dist_array import DistributedArray, make_array
from .faults import (
    FaultInjector,
    FaultSpec,
    InjectedError,
    InjectedFault,
    RecoveryPolicy,
    corrupt_transfer,
    decorrelated_jitter,
    fail_launch,
    fail_request,
    fail_step,
    fail_task,
    kill_worker,
    spurious_oom,
    timeout_transfer,
)
from .distributions import (
    BlockDist,
    Chunk,
    ColDist,
    CustomDist,
    Distribution,
    ReplicatedDist,
    RowDist,
    StencilDist,
    TileDist,
)
from .launch import Context, KernelDef, SuperblockInfo
from .memory import (
    HardwareModel,
    Interconnect,
    MemoryManager,
    OutOfMemory,
    Tier,
)
from .mesh import (
    Mesh,
    is_rank_mesh,
    make_mesh,
    mesh_coords,
    mesh_shape,
    mesh_size,
)
from .ndrange import Affine, Region
from .plan_ir import ArgPlan, CommPattern, ExecutionPlan, LaunchPlan, TaskKind
from .planner import ArrayMeta, Planner, Topology
from .reductions import collective_reduce, collective_reduce_ranks
from .scheduler import SimResult, Simulator
from .superblock import BlockWork, EvenWork, MeshWork, Superblock, TileWork

__all__ = [
    "Affine", "Annotation", "AnnotationError", "ArgPlan", "ArrayMeta",
    "BlockDist", "BlockWork", "Chunk", "ColDist", "CommPattern", "Context",
    "CustomDist", "DistributedArray", "Distribution", "EvenWork",
    "ExecutionPlan", "FaultInjector", "FaultSpec", "HardwareModel",
    "InjectedError", "InjectedFault", "Interconnect", "is_rank_mesh",
    "KernelDef",
    "LaunchPlan", "make_array", "make_mesh", "MemoryManager", "Mesh",
    "mesh_coords", "mesh_shape", "mesh_size",
    "MeshWork", "OutOfMemory", "parse", "Planner", "RecoveryPolicy",
    "Region", "ReplicatedDist", "RowDist", "SimResult", "Simulator",
    "StencilDist", "Superblock", "SuperblockInfo", "TaskKind", "Tier",
    "TileDist", "TileWork", "Topology", "collective_reduce",
    "collective_reduce_ranks",
    "corrupt_transfer", "decorrelated_jitter", "fail_launch",
    "fail_request", "fail_step", "fail_task", "kill_worker", "spurious_oom",
    "timeout_transfer",
]

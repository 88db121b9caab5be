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
from .ndrange import Affine, Region
from .plan_ir import ArgPlan, CommPattern, ExecutionPlan, LaunchPlan, TaskKind
from .planner import ArrayMeta, Planner, Topology
from .superblock import BlockWork, EvenWork, MeshWork, Superblock, TileWork

__all__ = [
    "Affine", "Annotation", "AnnotationError", "ArgPlan", "ArrayMeta",
    "BlockDist", "BlockWork", "Chunk", "ColDist", "CommPattern", "Context",
    "CustomDist", "DistributedArray", "Distribution", "EvenWork",
    "ExecutionPlan", "FaultInjector", "FaultSpec", "InjectedError",
    "InjectedFault",
    "KernelDef", "LaunchPlan", "make_array", "MeshWork", "parse", "Planner",
    "RecoveryPolicy", "Region", "ReplicatedDist", "RowDist", "StencilDist",
    "Superblock", "SuperblockInfo", "TaskKind", "TileDist", "TileWork",
    "Topology", "corrupt_transfer", "decorrelated_jitter", "fail_launch",
    "fail_request", "fail_step", "fail_task", "kill_worker", "spurious_oom",
    "timeout_transfer",
]

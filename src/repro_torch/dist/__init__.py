"""``repro_torch.dist`` — distribution across ranks and fault tolerance.

* :mod:`repro_torch.dist.sharding` — ``ShardingRules`` map logical array
  axes (``batch``, ``heads``, ``d_ff``, ...) onto mesh axes of the
  production ``("pod", "data", "model")`` mesh.  ``dp_rules`` is the
  paper-faithful baseline (batch superblocks, replicated weights);
  ``tp_rules`` the Megatron-style placement with a ZeRO-1 optimizer state.
  ``derive_rules_from_plan`` derives partition specs from a Lightning
  annotation (point accesses shard, slice and halo accesses replicate).
* :mod:`repro_torch.dist.ranks` — the named-axis primitives over
  ``torch.distributed`` ranks on a ``DeviceMesh`` (``psum``, ``pmax``,
  ``all_gather``, ``ppermute``, ``axis_index``), and ``spawn``, which starts
  the ranks of one machine.
* :mod:`repro_torch.dist.tensor_parallel` — the Megatron operators over
  the ``"model"`` axis that every family's layers run on when the rules
  split heads, d_ff, experts or vocab over more than one rank:
  ``copy_to_model``, ``reduce_from_model``, ``gather_from_model``, the
  vocab-split embedding lookup and cross-entropy.
* :mod:`repro_torch.dist.collectives` — a ring all-reduce from
  ``ppermute`` hops, the ring collective matmul, and the pod-then-data
  hierarchical gradient all-reduce, with spans on a ``dist`` stream.
* :mod:`repro_torch.dist.fault` — heartbeat liveness tracking, step-time
  straggler quarantine with backup shard assignment, and a
  checkpoint-restart supervisor; pure host-side logic on injected clocks.
"""

from .sharding import (
    MESH_AXES,
    ShardingRules,
    constrain,
    derive_rules_from_plan,
    dp_rules,
    tp_rules,
    tree_specs,
)
from .tensor_parallel import (
    copy_to_model,
    gather_from_model,
    reduce_from_model,
    vocab_parallel_embed,
    vocab_parallel_xent,
)
from .collectives import (
    hierarchical_grad_allreduce,
    ring_allgather_matmul,
    ring_allreduce,
    set_tracer,
)
from .fault import (
    FaultEvent,
    HeartbeatMonitor,
    HostState,
    StragglerMonitor,
    TrainSupervisor,
)
from .ranks import spawn

__all__ = [
    "MESH_AXES",
    "ShardingRules",
    "constrain",
    "derive_rules_from_plan",
    "dp_rules",
    "tp_rules",
    "tree_specs",
    "copy_to_model",
    "gather_from_model",
    "reduce_from_model",
    "vocab_parallel_embed",
    "vocab_parallel_xent",
    "hierarchical_grad_allreduce",
    "ring_allgather_matmul",
    "ring_allreduce",
    "set_tracer",
    "spawn",
    "FaultEvent",
    "HeartbeatMonitor",
    "HostState",
    "StragglerMonitor",
    "TrainSupervisor",
]

"""``repro_torch.dist`` — distribution across ranks and fault tolerance.

* :mod:`repro_torch.dist.sharding` — only the one-device ``constrain`` so
  far (ROADMAP Queue A item 10 holds the logical-axis rules and the
  collectives).
* :mod:`repro_torch.dist.fault` — heartbeat liveness tracking, step-time
  straggler quarantine with backup shard assignment, and a
  checkpoint-restart supervisor; pure host-side logic on injected clocks.
"""

from .fault import (
    FaultEvent,
    HeartbeatMonitor,
    HostState,
    StragglerMonitor,
    TrainSupervisor,
)
from .sharding import constrain

__all__ = [
    "constrain",
    "FaultEvent",
    "HeartbeatMonitor",
    "HostState",
    "StragglerMonitor",
    "TrainSupervisor",
]

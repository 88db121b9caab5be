"""A rank's collectives, FLOPs and bytes for the dry run.

The reference reads these from XLA: the collective traffic parsed from the
compiled, partitioned HLO, and the FLOPs and bytes accessed from
``compiled.cost_analysis()``.  The port has no HLO: its steps run eagerly,
one aten op after another.  What stands in for each:

* **Collectives.**  Every collective of the port goes through
  :mod:`repro_torch.dist.ranks` (``psum``, ``pmax``, ``all_gather``,
  ``ppermute``; the ``collective:*`` spans of ``dist.tensor_parallel`` and
  ``dist.collectives`` sit above them).  Under a recording mesh
  (``ranks.recording``) each of those calls on ``meta`` tensors is
  recorded as ``(op, axis, operand bytes, output bytes)``, and
  :func:`collective_stats` sums the records by op, onto
  :data:`COLLECTIVE_OPS`: ``psum`` and ``pmax`` are ``all-reduce``,
  ``all_gather`` is ``all-gather``, ``ppermute`` is
  ``collective-permute``.  The port issues no reduce-scatter and no
  all-to-all: ``gather_from_model``'s backward all-reduces the whole
  gradient and keeps the rank's slice, and is counted as the all-reduce
  it is.  Every call is counted, one over an axis of one rank included.
* **FLOPs.**  ``torch.utils.flop_counter.FlopCounterMode`` over the meta
  run (matrix products, forward and backward, and remat's recompute).
* **Bytes.**  A ``TorchDispatchMode`` sums each aten op's tensor operand
  and output bytes (a view moves none): eager, unfused traffic, so an upper
  bound on what a fused program reads and writes.

Under SPMD the reference's counts are one device's; these are one rank's.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Iterable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

COLLECTIVE_OPS = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)


@dataclasses.dataclass
class CollectiveStats:
    operand_bytes: dict[str, int]
    output_bytes: dict[str, int]
    counts: dict[str, int]

    @property
    def total_operand_bytes(self) -> int:
        return sum(self.operand_bytes.values())

    def summary(self) -> dict:
        return {
            "total_bytes": self.total_operand_bytes,
            "by_op_bytes": dict(self.operand_bytes),
            "output_bytes": dict(self.output_bytes),
            "counts": dict(self.counts),
        }


def collective_stats(records: Iterable[tuple]) -> CollectiveStats:
    """The records of a recording mesh (``RecordingMesh.records``: ``(op,
    axis, operand bytes, output bytes)``) summed by op."""
    operand = defaultdict(int)
    output = defaultdict(int)
    counts = defaultdict(int)
    for op, _, in_bytes, out_bytes in records:
        if op not in COLLECTIVE_OPS:
            raise ValueError(f"not a collective op: {op!r}")
        counts[op] += 1
        operand[op] += in_bytes
        output[op] += out_bytes
    return CollectiveStats(dict(operand), dict(output), dict(counts))


def flops_and_bytes(cost_analysis: dict | None) -> tuple[float, float]:
    """(flops, bytes accessed) from a cost dict with the reference's keys
    (``CostCounter.cost_analysis()``)."""
    if not cost_analysis:
        return 0.0, 0.0
    return (float(cost_analysis.get("flops", 0.0)),
            float(cost_analysis.get("bytes accessed", 0.0)))


def _tensor_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree)
               if isinstance(x, torch.Tensor))


class _ByteCounter(TorchDispatchMode):
    """Sums the tensor bytes each aten op reads and writes."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not func.is_view:
            self.bytes += _tensor_bytes((args, kwargs)) + _tensor_bytes(out)
        return out


class CostCounter:
    """A block's FLOPs (``FlopCounterMode``) and eager aten bytes, read
    after it by ``cost_analysis()`` under the reference's keys."""

    def __init__(self):
        self._flops = FlopCounterMode(display=False)
        self._bytes = _ByteCounter()

    def __enter__(self):
        self._flops.__enter__()
        self._bytes.__enter__()
        return self

    def __exit__(self, *exc):
        self._bytes.__exit__(*exc)
        self._flops.__exit__(*exc)
        return False

    def cost_analysis(self) -> dict:
        return {"flops": float(self._flops.get_total_flops()),
                "bytes accessed": float(self._bytes.bytes)}

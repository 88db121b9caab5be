"""Overlap analyzer: how much of the wall clock hid transfers behind compute.

Lightning's efficiency claim is that scheduling, data movement, and kernel
execution *overlap*.  Rather than hand-maintaining an "overlap" statistic in
the scheduler, this module derives it from the trace after the fact: feed it
a :class:`~repro_torch.obs.trace.Tracer` (or an exported Chrome trace) and it
reports, per device, the fraction of busy wall clock where compute ran
concurrently with transfers/scheduling — the paper's figure-style
efficiency number.

Categories come from each span's ``cat`` field; the runtime emits
``compute`` (kernel execution, reductions, lineage replays), ``transfer``
(staging h2d, intra-node copies, network send/recv), and ``sched``
(planner/driver work).  Unknown categories are ignored.
"""

from __future__ import annotations

import dataclasses

from .trace import Tracer

#: Span categories the runtime emits (cat → analyzer group).
COMPUTE_CATS = ("compute",)
TRANSFER_CATS = ("transfer",)
SCHED_CATS = ("sched",)


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """Merge possibly-overlapping [start, end) intervals."""
    merged: list[tuple[float, float]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], e))
        else:
            merged.append((s, e))
    return merged


def _total(intervals: list[tuple[float, float]]) -> float:
    return sum(e - s for s, e in intervals)


def _intersect(a: list[tuple[float, float]],
               b: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[tuple[float, float]] = []
    i = j = 0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            out.append((lo, hi))
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return out


@dataclasses.dataclass
class DeviceOverlap:
    """Per-device busy/overlap accounting (all seconds)."""

    worker: int
    wall: float  # global trace wall clock (shared by all devices)
    busy: dict[str, float]  # group ("compute"/"transfer"/"sched") → union-busy
    overlap: float  # compute ∩ (transfer ∪ sched)
    # Transfer union-busy seconds split per executor stream (h2d / d2d /
    # copy / net) — shows how much of the movement rode the peer-to-peer
    # fabric vs the host link.  Empty when the trace carries no stream
    # information (exported Chrome dicts map streams to numeric tids).
    transfer_streams: dict[str, float] = dataclasses.field(
        default_factory=dict)

    @property
    def overlap_fraction(self) -> float:
        """Fraction of the wall clock where compute hid other work."""
        return self.overlap / self.wall if self.wall > 0 else 0.0

    @property
    def exposed_transfer(self) -> float:
        """Transfer seconds *not* hidden behind compute — the cost the
        paper's overlapped scheduler exists to eliminate."""
        return max(0.0, self.busy.get("transfer", 0.0) - self.overlap)

    def to_dict(self) -> dict:
        return {
            "worker": self.worker, "wall_s": self.wall,
            "busy_s": dict(self.busy), "overlap_s": self.overlap,
            "overlap_fraction": self.overlap_fraction,
            "exposed_transfer_s": self.exposed_transfer,
            "transfer_streams_s": dict(self.transfer_streams),
        }


@dataclasses.dataclass
class OverlapReport:
    wall: float
    devices: list[DeviceOverlap]

    @property
    def overlap_fraction(self) -> float:
        """Mean per-device overlap fraction (devices share the wall)."""
        if not self.devices:
            return 0.0
        return sum(d.overlap_fraction for d in self.devices) / len(self.devices)

    def device(self, worker: int) -> DeviceOverlap | None:
        return next((d for d in self.devices if d.worker == worker), None)

    def to_dict(self) -> dict:
        return {
            "wall_s": self.wall,
            "overlap_fraction": self.overlap_fraction,
            "devices": [d.to_dict() for d in self.devices],
        }

    def summary(self) -> str:
        lines = [
            f"overlap report: wall {self.wall:.6g}s, "
            f"mean compute/transfer overlap "
            f"{self.overlap_fraction * 100.0:.1f}%"
        ]
        for d in self.devices:
            comp = d.busy.get("compute", 0.0)
            xfer = d.busy.get("transfer", 0.0)
            lines.append(
                f"  worker{d.worker}: compute {comp:.6g}s, "
                f"transfer {xfer:.6g}s, overlapped {d.overlap:.6g}s "
                f"({d.overlap_fraction * 100.0:.1f}% of wall), "
                f"exposed transfer {d.exposed_transfer:.6g}s"
            )
        return "\n".join(lines)


def _spans_of(trace) -> list[tuple[float, float, int, str, str]]:
    """Normalize input → [(start_s, end_s, worker, cat, stream)] for span
    events.

    Accepts a live :class:`Tracer` (seconds) or an exported Chrome trace
    dict / event list (microseconds).  Exported traces carry streams as
    numeric tids, so stream names are only available from a live tracer —
    Chrome-dict spans get ``stream=""`` and the per-stream transfer
    breakdown stays empty."""
    if isinstance(trace, Tracer):
        return [
            (e["ts"], e["ts"] + e["dur"], e["pid"], e["cat"],
             str(e.get("stream", "")))
            for e in trace.events if e["ph"] == "X"
        ]
    events = trace.get("traceEvents", []) if isinstance(trace, dict) else trace
    return [
        (e["ts"] / 1e6, (e["ts"] + e.get("dur", 0.0)) / 1e6,
         int(e.get("pid", 0)), e.get("cat", ""), "")
        for e in events if e.get("ph") == "X"
    ]


def analyze(trace) -> OverlapReport:
    """Derive per-device compute/transfer overlap from a trace."""
    spans = _spans_of(trace)
    if not spans:
        return OverlapReport(wall=0.0, devices=[])
    t0 = min(s[0] for s in spans)
    t1 = max(s[1] for s in spans)
    wall = max(t1 - t0, 0.0)

    groups = {"compute": COMPUTE_CATS, "transfer": TRANSFER_CATS,
              "sched": SCHED_CATS}
    per_dev: dict[int, dict[str, list[tuple[float, float]]]] = {}
    per_stream: dict[int, dict[str, list[tuple[float, float]]]] = {}
    for s, e, w, cat, stream in spans:
        group = next((g for g, cats in groups.items() if cat in cats), None)
        if group is None:
            continue
        per_dev.setdefault(w, {g: [] for g in groups})[group].append((s, e))
        if group == "transfer" and stream:
            per_stream.setdefault(w, {}).setdefault(stream, []).append((s, e))

    devices = []
    for w in sorted(per_dev):
        unions = {g: _union(iv) for g, iv in per_dev[w].items()}
        other = _union(unions["transfer"] + unions["sched"])
        overlap = _total(_intersect(unions["compute"], other))
        devices.append(DeviceOverlap(
            worker=w, wall=wall,
            busy={g: _total(u) for g, u in unions.items()},
            overlap=overlap,
            transfer_streams={
                st: _total(_union(iv))
                for st, iv in sorted(per_stream.get(w, {}).items())
            },
        ))
    return OverlapReport(wall=wall, devices=devices)


__all__ = ["DeviceOverlap", "OverlapReport", "analyze"]

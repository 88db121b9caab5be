"""Fault tolerance for multi-host training: heartbeats, stragglers,
checkpoint-restart supervision.

Three cooperating pieces, all pure host-side logic (injectable clock, no
real multi-host requirement) so every failure mode is deterministically
testable:

* :class:`HeartbeatMonitor` — per-host liveness + step-time history.  Hosts
  report a beat per training step; a host whose last beat is older than
  ``timeout`` is dead.
* :class:`StragglerMonitor` — flags hosts whose recent step time is an
  outlier (``threshold`` × the cross-host median) for ``patience``
  consecutive evaluations, quarantines them, and computes a backup
  assignment of their data shards onto the healthy hosts.
* :class:`TrainSupervisor` — retry/backoff wrapper around the training
  loop: on failure it records the event, backs off, and re-enters the loop
  from the latest checkpoint step, giving up after ``max_restarts``.

The supervisor touches its checkpoint manager only through
``latest_step()``, so any object with that method serves.  The port's
simulator (:mod:`repro_torch.core.scheduler`) re-plans a dead worker's tasks
through :meth:`StragglerMonitor.backup_assignment`.
"""

from __future__ import annotations

import dataclasses
import random
import statistics
import time
from collections import deque
from typing import Callable

from repro_torch.core.faults import decorrelated_jitter
from repro_torch.obs.metrics import default_registry


@dataclasses.dataclass
class HostState:
    """Mutable per-host record kept by :class:`HeartbeatMonitor`."""

    host: int
    last_beat: float | None = None
    step_times: deque = dataclasses.field(
        default_factory=lambda: deque(maxlen=32)
    )
    quarantined: bool = False
    straggler_flags: int = 0  # consecutive outlier evaluations

    def recent_step_time(self, window: int = 8) -> float | None:
        if not self.step_times:
            return None
        tail = list(self.step_times)[-window:]
        return sum(tail) / len(tail)


class HeartbeatMonitor:
    """Tracks liveness and step times for ``num_hosts`` workers."""

    def __init__(
        self,
        num_hosts: int,
        timeout: float = 60.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.timeout = float(timeout)
        self.clock = clock
        self.hosts = [HostState(h) for h in range(num_hosts)]

    def beat(self, host: int, step_time: float) -> None:
        state = self.hosts[host]
        state.last_beat = self.clock()
        state.step_times.append(float(step_time))

    def dead_hosts(self) -> list[int]:
        """Hosts that have beaten before but fell silent past the timeout."""
        now = self.clock()
        return [
            h.host
            for h in self.hosts
            if h.last_beat is not None and now - h.last_beat > self.timeout
        ]

    def healthy_hosts(self) -> list[int]:
        dead = set(self.dead_hosts())
        return [
            h.host
            for h in self.hosts
            if not h.quarantined and h.host not in dead
        ]


class StragglerMonitor:
    """Quarantines hosts whose step time is a persistent outlier.

    ``evaluate()`` compares each active host's recent mean step time with
    the median across active hosts; a host exceeding ``threshold`` × median
    accumulates a flag, and ``patience`` consecutive flags quarantine it
    (one transient slow step never does).  Needs ≥ 2 reporting hosts — a
    single host has no peer baseline."""

    def __init__(
        self,
        monitor: HeartbeatMonitor,
        threshold: float = 2.0,
        patience: int = 5,
        window: int = 8,
    ):
        self.monitor = monitor
        self.threshold = float(threshold)
        self.patience = int(patience)
        self.window = int(window)

    def evaluate(self) -> list[int]:
        """Run one detection round; returns newly quarantined host ids."""
        active = [
            h for h in self.monitor.hosts
            if not h.quarantined and h.step_times
        ]
        if len(active) < 2:
            return []
        times = {h.host: h.recent_step_time(self.window) for h in active}
        median = statistics.median(times.values())
        newly: list[int] = []
        for h in active:
            if median > 0 and times[h.host] > self.threshold * median:
                h.straggler_flags += 1
            else:
                h.straggler_flags = 0
            if h.straggler_flags >= self.patience:
                h.quarantined = True
                newly.append(h.host)
                default_registry().counter("dist.quarantines").labels(
                    host=str(h.host)).inc()
        if newly:
            default_registry().gauge("dist.healthy_hosts").set(
                len(self.monitor.healthy_hosts()))
        return newly

    def backup_assignment(self, data_shards: int) -> dict[int, list[int]]:
        """Round-robin all ``data_shards`` over the healthy hosts.

        Quarantined/dead hosts' shards land on healthy peers (every shard
        index appears exactly once across the returned lists)."""
        healthy = self.monitor.healthy_hosts()
        if not healthy:
            raise RuntimeError("no healthy hosts left to assign shards to")
        assignment: dict[int, list[int]] = {h: [] for h in healthy}
        for shard in range(data_shards):
            assignment[healthy[shard % len(healthy)]].append(shard)
        return assignment


@dataclasses.dataclass
class FaultEvent:
    kind: str  # "failure" | "resume" | "complete"
    step: int
    detail: str = ""
    at: float = 0.0  # supervisor clock timestamp


class TrainSupervisor:
    """Checkpoint-restart supervision around a training loop.

    ``run(step_fn, total_steps)`` calls ``step_fn(start_step)`` and expects
    it to return the final step reached.  On any exception it records a
    ``failure`` event, sleeps a backoff, re-reads the latest checkpoint
    step from the manager, records ``resume``, and re-enters the loop there
    — up to ``max_restarts`` times before re-raising.

    Time is fully injected (``clock`` for event timestamps, ``sleep`` for
    the backoff — no bare ``time.sleep`` anywhere), so every restart path
    is deterministic under test.  Backoff is capped exponential by
    default; pass ``jitter_seed`` to switch to seeded *decorrelated
    jitter* so a fleet of hosts that failed together doesn't re-enter (and
    re-fail) in lock-step."""

    def __init__(
        self,
        ckpt_manager,
        max_restarts: int = 3,
        backoff: float = 0.0,
        max_backoff: float = 30.0,
        sleep: Callable[[float], None] = time.sleep,
        clock: Callable[[], float] = time.monotonic,
        jitter_seed: int | None = None,
    ):
        self.ckpt = ckpt_manager
        self.max_restarts = int(max_restarts)
        self.backoff = float(backoff)
        self.max_backoff = float(max_backoff)
        self.sleep = sleep
        self.clock = clock
        self._rng = (random.Random(jitter_seed)
                     if jitter_seed is not None else None)
        self._prev_delay: float | None = None
        self.events: list[FaultEvent] = []

    def _backoff_delay(self, restarts: int) -> float:
        if self._rng is not None:
            prev = self._prev_delay if self._prev_delay else self.backoff
            delay = decorrelated_jitter(prev, self.backoff,
                                        self.max_backoff, self._rng)
        else:
            delay = min(self.backoff * 2 ** (restarts - 1), self.max_backoff)
        self._prev_delay = delay
        return delay

    def _latest_step(self) -> int:
        if self.ckpt is None:
            return 0
        step = self.ckpt.latest_step()
        return 0 if step is None else int(step)

    def run(self, step_fn: Callable[[int], int], total_steps: int) -> int:
        start = 0
        restarts = 0
        while True:
            try:
                last = int(step_fn(start))
            except Exception as exc:  # noqa: BLE001 — any worker loss
                self.events.append(
                    FaultEvent("failure", self._latest_step(), repr(exc),
                               at=self.clock())
                )
                default_registry().counter("dist.supervisor_events").labels(
                    kind="failure").inc()
                if restarts >= self.max_restarts:
                    raise
                restarts += 1
                if self.backoff:
                    self.sleep(self._backoff_delay(restarts))
                start = self._latest_step()
                self.events.append(
                    FaultEvent(
                        "resume", start,
                        f"restart {restarts}/{self.max_restarts}",
                        at=self.clock(),
                    )
                )
                default_registry().counter("dist.supervisor_events").labels(
                    kind="resume").inc()
                continue
            self.events.append(
                FaultEvent("complete", last, f"target {total_steps}",
                           at=self.clock())
            )
            default_registry().counter("dist.supervisor_events").labels(
                kind="complete").inc()
            return last

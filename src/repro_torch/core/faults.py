"""Deterministic fault injection + recovery policy for the Lightning runtime.

The planner already knows every task's dependencies and every chunk's
location (paper §3.2–3.4); that is exactly the information needed to
*recover* from a failed kernel launch, a dropped transfer, or a dead
worker instead of aborting the whole plan.  This module provides the two
pieces the rest of the runtime threads through:

* :class:`FaultInjector` — a seeded, schedulable source of injected
  failures.  Call sites *probe* it (``injector.probe("task", worker=w,
  task=tid)``) and it answers deterministically from a list of
  :class:`FaultSpec` triggers (fire on the Nth matching probe) and/or a
  seeded RNG (fire with probability p).  Every firing is recorded in
  ``injector.events`` so tests can assert exactly which faults ran.
* :class:`RecoveryPolicy` — capped-exponential backoff knobs shared by the
  simulator, the launcher (:mod:`repro_torch.core.launch`), and the
  serve engine.

Probe kinds used across the runtime:

========== =====================================================
``task``             a task execution fails after running (scheduler)
``transfer_timeout`` a COPY/SEND/RECV hangs past its deadline (scheduler)
``transfer_corrupt`` a transfer completes but the payload is bad (scheduler)
``oom``              a spurious allocation failure (memory manager)
``worker_death``     a worker dies after completing a task (scheduler)
``launch``           a distributed kernel launch fails (Context)
``step``             one training step raises (launch/train)
``request``          one serve request's prefill/decode raises (serve)
``decode``           a whole decode batch step raises (serve)
========== =====================================================

Everything is plain host-side Python — no wall clock, no global state —
so every recovery path is exercisable in CI with a fixed seed
(``REPRO_FAULT_SEED``).
"""

from __future__ import annotations

import dataclasses
import os
import random
from typing import Iterable, Sequence

from repro_torch.obs.metrics import MetricsRegistry, default_registry


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One injected-failure trigger.

    A spec *matches* a probe when ``kind`` equals the probe kind and the
    ``worker``/``task``/``label`` filters (when set) equal the probe's.
    Matching probes are counted per spec; the spec fires on occurrences
    ``at <= n < at + times`` (deterministic schedule), or — when
    ``probability`` is set — on each matching probe with that probability,
    up to ``times`` total firings (``times <= 0`` means unlimited).
    """

    kind: str
    at: int | None = None  # 0-based index among matching probes
    worker: int | None = None
    task: int | None = None
    label: str | None = None  # substring match on the probe site
    probability: float = 0.0
    times: int = 1

    def matches(self, kind: str, worker, task, site: str) -> bool:
        if self.kind != kind:
            return False
        if self.worker is not None and self.worker != worker:
            return False
        if self.task is not None and self.task != task:
            return False
        if self.label is not None and self.label not in site:
            return False
        return True


@dataclasses.dataclass(frozen=True)
class InjectedFault:
    """Record of one fault actually fired (``injector.events``)."""

    kind: str
    worker: int | None = None
    task: int | None = None
    site: str = ""


class InjectedError(RuntimeError):
    """What a call site raises when its probe fires.  Recovery code that
    absorbs failures (the serve engine) retries and absorbs this type only,
    so that a real failure, such as a kernel's CUDA error, propagates."""


class FaultInjector:
    """Seeded, deterministic fault source threaded through the runtime.

    ``probe(kind, ...)`` returns True when a fault should fire at this
    call site.  The same (seed, specs, probe sequence) always yields the
    same answer — recovery paths are replayable bug reports, not flakes.
    """

    def __init__(self, specs: Iterable[FaultSpec] = (), seed: int = 0,
                 *, registry: MetricsRegistry | None = None):
        self.specs: list[FaultSpec] = list(specs)
        self.seed = int(seed)
        self.rng = random.Random(self.seed)
        self.events: list[InjectedFault] = []
        self._seen = [0] * len(self.specs)
        self._fired = [0] * len(self.specs)
        self._registry = registry

    @classmethod
    def from_env(cls, specs: Iterable[FaultSpec] = (),
                 env=os.environ) -> "FaultInjector":
        """Build with the CI chaos seed (``REPRO_FAULT_SEED``, default 0)."""
        return cls(specs, seed=int(env.get("REPRO_FAULT_SEED", "0")))

    def probe(self, kind: str, *, worker: int | None = None,
              task: int | None = None, site: str = "") -> bool:
        fired = False
        for i, spec in enumerate(self.specs):
            if not spec.matches(kind, worker, task, site):
                continue
            n = self._seen[i]
            self._seen[i] += 1
            if spec.times > 0 and self._fired[i] >= spec.times:
                continue
            if spec.probability > 0.0:
                hit = self.rng.random() < spec.probability
            elif spec.at is not None:
                hit = spec.at <= n and (spec.times <= 0
                                        or n < spec.at + spec.times)
            else:
                hit = spec.times <= 0 or n < spec.times
            if hit:
                self._fired[i] += 1
                fired = True
        if fired:
            self.events.append(InjectedFault(kind, worker, task, site))
            reg = self._registry if self._registry is not None \
                else default_registry()
            reg.counter("faults.injected").labels(kind=kind).inc()
        return fired

    def count(self, kind: str | None = None) -> int:
        if kind is None:
            return len(self.events)
        return sum(1 for e in self.events if e.kind == kind)


# -- spec constructors (readable fault schedules in tests/benchmarks) --------


def fail_task(at: int = 0, *, worker: int | None = None,
              task: int | None = None, label: str | None = None,
              times: int = 1, probability: float = 0.0) -> FaultSpec:
    return FaultSpec("task", at=None if probability else at, worker=worker,
                     task=task, label=label, times=times,
                     probability=probability)


def timeout_transfer(at: int = 0, *, times: int = 1,
                     probability: float = 0.0) -> FaultSpec:
    return FaultSpec("transfer_timeout", at=None if probability else at,
                     times=times, probability=probability)


def corrupt_transfer(at: int = 0, *, times: int = 1,
                     probability: float = 0.0) -> FaultSpec:
    return FaultSpec("transfer_corrupt", at=None if probability else at,
                     times=times, probability=probability)


def spurious_oom(at: int = 0, *, worker: int | None = None,
                 times: int = 1, probability: float = 0.0) -> FaultSpec:
    return FaultSpec("oom", at=None if probability else at, worker=worker,
                     times=times, probability=probability)


def kill_worker(worker: int, after: int = 0) -> FaultSpec:
    """Kill ``worker`` once it has completed ``after`` tasks."""
    return FaultSpec("worker_death", at=after, worker=worker, times=1)


def fail_launch(at: int = 0, *, label: str | None = None,
                times: int = 1) -> FaultSpec:
    return FaultSpec("launch", at=at, label=label, times=times)


def fail_step(at: int, *, times: int = 1) -> FaultSpec:
    """Fail the training step whose number is ``at`` (task=step probes)."""
    return FaultSpec("step", task=at, times=times)


def fail_request(rid: int, *, times: int = 1) -> FaultSpec:
    """Fail serve request ``rid``; ``times<=0`` makes it fail permanently."""
    return FaultSpec("request", task=rid, times=times)


# -- recovery policy ---------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RecoveryPolicy:
    """Retry/backoff/degradation knobs shared across the runtime."""

    max_attempts: int = 4  # retries per task/launch/request before giving up
    backoff: float = 1e-4  # base retry delay (simulated seconds)
    max_backoff: float = 1e-2
    jitter: float = 0.5  # fraction of the delay randomized (0 = none)
    transfer_timeout: float = 1e-3  # extra stall modeled for a hung transfer
    oom_degrade_after: int = 1  # consecutive OOMs before tier demotion

    def delay(self, attempt: int, rng: random.Random | None = None) -> float:
        """Capped exponential backoff for the ``attempt``-th retry (1-based),
        with optional seeded jitter so retries don't synchronize."""
        d = min(self.backoff * 2.0 ** max(0, attempt - 1), self.max_backoff)
        if rng is not None and self.jitter > 0.0:
            d *= 1.0 - self.jitter / 2.0 + self.jitter * rng.random()
        return d


def decorrelated_jitter(prev: float, base: float, cap: float,
                        rng: random.Random) -> float:
    """AWS-style decorrelated-jitter backoff: ``min(cap, U(base, prev*3))``.

    Unlike pure exponential backoff, concurrent clients that failed at the
    same moment spread out instead of hammering the recovered resource in
    lock-step."""
    prev = max(prev, base)
    return min(cap, rng.uniform(base, prev * 3.0))


__all__ = [
    "FaultSpec", "FaultInjector", "InjectedError", "InjectedFault",
    "RecoveryPolicy",
    "decorrelated_jitter", "fail_task", "timeout_transfer",
    "corrupt_transfer", "spurious_oom", "kill_worker", "fail_launch",
    "fail_step", "fail_request",
]

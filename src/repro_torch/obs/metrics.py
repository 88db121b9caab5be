"""Metrics registry: counters, gauges, and fixed-bucket histograms.

Dependency-free (stdlib only) so every layer of the runtime — including
:mod:`repro_torch.core.faults` — can record metrics.

Design (a deliberately small slice of the Prometheus model):

* every metric is **named** and lives in a :class:`MetricsRegistry`;
  ``registry.counter(name)`` is get-or-create, so independent call sites
  that agree on a name share one metric;
* a metric can have **labeled children** (``counter.labels(kind="task")``)
  — the parent's :meth:`~Counter.value` aggregates its own increments plus
  all children, which is what replaces hand-summed per-worker stat merges
  in the scheduler;
* :meth:`MetricsRegistry.snapshot` flattens everything to a plain
  ``{name: value}`` dict (children keyed ``name{k=v,...}``), and
  :meth:`MetricsRegistry.diff` / :meth:`MetricsRegistry.merge` make
  per-run deltas and cross-worker aggregation one-liners;
* a **process-global default registry** exists for code that isn't handed
  one explicitly; tests swap it with :func:`use_registry`.

Everything is deterministic: no wall-clock reads, no randomness, stable
(sorted) iteration everywhere.
"""

from __future__ import annotations

import bisect
import contextlib
from typing import Iterator, Mapping

#: Default latency buckets (seconds): 100 µs .. 30 s, roughly ×3 spaced.
DEFAULT_BUCKETS = (
    1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 0.1, 0.3, 1.0, 3.0, 10.0, 30.0,
)


def _label_key(labels: Mapping[str, object]) -> tuple[tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _format_key(name: str, key: tuple[tuple[str, str], ...]) -> str:
    inner = ",".join(f"{k}={v}" for k, v in key)
    return f"{name}{{{inner}}}"


class Metric:
    """Base: name + help + labeled children (same concrete type)."""

    kind = "metric"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._children: dict[tuple[tuple[str, str], ...], "Metric"] = {}
        self._labels: tuple[tuple[str, str], ...] = ()

    def labels(self, **labels) -> "Metric":
        """Get-or-create the child metric for this label set."""
        key = _label_key(labels)
        child = self._children.get(key)
        if child is None:
            child = type(self)(self.name, self.help, **self._child_kwargs())
            child._labels = key
            self._children[key] = child
        return child

    def _child_kwargs(self) -> dict:
        return {}

    def children(self) -> Iterator[tuple[tuple[tuple[str, str], ...], "Metric"]]:
        for key in sorted(self._children):
            yield key, self._children[key]

    # subclasses define value() and _merge_own()

    def _merge_from(self, other: "Metric") -> None:
        self._merge_own(other)
        for key, child in other.children():
            mine = self._children.get(key)
            if mine is None:
                mine = type(self)(self.name, self.help, **self._child_kwargs())
                mine._labels = key
                self._children[key] = mine
            mine._merge_own(child)


class Counter(Metric):
    """Monotonic float counter; ``value()`` sums own + children."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (inc {n})")
        self._value += n

    def value(self) -> float:
        return self._value + sum(c.value() for c in self._children.values())

    def _merge_own(self, other: "Counter") -> None:
        self._value += other._value


class Gauge(Metric):
    """Settable instantaneous value; parent aggregates children by sum."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._value = 0.0

    def set(self, v: float) -> None:
        self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self._value += n

    def dec(self, n: float = 1.0) -> None:
        self._value -= n

    def value(self) -> float:
        return self._value + sum(c.value() for c in self._children.values())

    def _merge_own(self, other: "Gauge") -> None:
        self._value += other._value


class Histogram(Metric):
    """Fixed-bucket histogram (upper bounds + overflow), plus sum/count.

    ``quantile(q)`` answers with the upper bound of the bucket holding the
    q-th observation — coarse, deterministic, and enough to spot a tail.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: tuple[float, ...] = DEFAULT_BUCKETS):
        super().__init__(name, help)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self._counts = [0] * (len(self.buckets) + 1)  # last = overflow
        self._sum = 0.0
        self._count = 0

    def _child_kwargs(self) -> dict:
        return {"buckets": self.buckets}

    def observe(self, v: float) -> None:
        v = float(v)
        self._counts[bisect.bisect_left(self.buckets, v)] += 1
        self._sum += v
        self._count += 1

    def counts(self) -> list[int]:
        out = list(self._counts)
        for c in self._children.values():
            for i, n in enumerate(c.counts()):
                out[i] += n
        return out

    def count(self) -> int:
        return self._count + sum(c.count() for c in self._children.values())

    def sum(self) -> float:
        return self._sum + sum(c.sum() for c in self._children.values())

    def value(self) -> float:
        """Snapshot scalar for a histogram: its observation count."""
        return float(self.count())

    def mean(self) -> float:
        n = self.count()
        return self.sum() / n if n else 0.0

    def quantile(self, q: float) -> float:
        n = self.count()
        if n == 0:
            return 0.0
        rank = max(1, int(q * n + 0.999999))
        seen = 0
        counts = self.counts()
        for i, c in enumerate(counts):
            seen += c
            if seen >= rank:
                if i < len(self.buckets):
                    return self.buckets[i]
                return float("inf")
        return float("inf")  # pragma: no cover

    def _merge_own(self, other: "Histogram") -> None:
        if other.buckets != self.buckets:
            raise ValueError(
                f"histogram {self.name}: bucket mismatch on merge"
            )
        for i, c in enumerate(other._counts):
            self._counts[i] += c
        self._sum += other._sum
        self._count += other._count


class MetricsRegistry:
    """Named metrics with get-or-create accessors and snapshot/diff/merge."""

    def __init__(self):
        self._metrics: dict[str, Metric] = {}

    def _get_or_create(self, cls, name: str, help: str, **kw) -> Metric:
        m = self._metrics.get(name)
        if m is None:
            m = cls(name, help, **kw)
            self._metrics[name] = m
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as {m.kind}, "
                f"requested {cls.kind}"
            )
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: tuple[float, ...] | None = None) -> Histogram:
        return self._get_or_create(
            Histogram, name, help, buckets=buckets or DEFAULT_BUCKETS
        )

    def get(self, name: str) -> Metric | None:
        return self._metrics.get(name)

    def metrics(self) -> Iterator[Metric]:
        for name in sorted(self._metrics):
            yield self._metrics[name]

    def snapshot(self) -> dict[str, float]:
        """Flatten to ``{name: value}``; labeled children as ``name{k=v}``;
        histograms additionally expose ``name.sum`` / ``name.count``."""
        out: dict[str, float] = {}
        for m in self.metrics():
            out[m.name] = m.value()
            if isinstance(m, Histogram):
                out[f"{m.name}.sum"] = m.sum()
                out[f"{m.name}.count"] = float(m.count())
            for key, child in m.children():
                out[_format_key(m.name, key)] = child.value()
        return out

    @staticmethod
    def diff(after: Mapping[str, float],
             before: Mapping[str, float]) -> dict[str, float]:
        """Per-key ``after - before`` over the union of keys."""
        keys = set(after) | set(before)
        return {k: after.get(k, 0.0) - before.get(k, 0.0)
                for k in sorted(keys)}

    def merge(self, other: "MetricsRegistry") -> None:
        """Fold ``other``'s metrics into this registry (sum semantics) —
        aggregation across per-worker or per-process registries."""
        for src in other.metrics():
            dst = self._get_or_create(
                type(src), src.name, src.help,
                **(src._child_kwargs() if isinstance(src, Histogram) else {})
            )
            dst._merge_from(src)


# -- process-global default registry ------------------------------------------

_default: MetricsRegistry = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return _default


def set_default_registry(reg: MetricsRegistry) -> MetricsRegistry:
    """Swap the process default; returns the previous one."""
    global _default
    prev, _default = _default, reg
    return prev


@contextlib.contextmanager
def use_registry(reg: MetricsRegistry | None = None):
    """Context manager: swap the default registry in, restore on exit."""
    reg = reg or MetricsRegistry()
    prev = set_default_registry(reg)
    try:
        yield reg
    finally:
        set_default_registry(prev)


__all__ = [
    "DEFAULT_BUCKETS", "Counter", "Gauge", "Histogram", "Metric",
    "MetricsRegistry", "default_registry", "set_default_registry",
    "use_registry",
]

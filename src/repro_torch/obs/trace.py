"""Runtime tracer: nestable spans + instant events → Perfetto timelines.

The runtime has two notions of time and the tracer serves both:

* the **discrete-event simulator** knows exact simulated timestamps — it
  records *complete* events explicitly (:meth:`Tracer.complete` with
  ``ts``/``dur``);
* the **serve/train/launch** layers live in host time — they open
  *nestable spans* (:meth:`Tracer.span` as a context manager) stamped by
  the tracer's injected ``clock``.

Events carry ``worker`` (→ Chrome ``pid``) and ``stream`` (→ Chrome
``tid``), mirroring the per-worker executor streams of the scheduler
(compute / h2d / copy / net), so the exported timeline shows exactly the
overlap the paper claims.  Export formats:

* :meth:`Tracer.to_json` — Chrome trace-event JSON, loadable in Perfetto
  (https://ui.perfetto.dev) or ``chrome://tracing``.  Output is fully
  deterministic: sorted keys, stable event order, timestamps only from
  the injected clock or explicit ``ts`` arguments — never the wall clock.
* :meth:`Tracer.text_timeline` — a plain-text lane-per-stream timeline
  for terminals and logs.

Zero cost when disabled: :data:`NULL_TRACER` answers every ``span()`` with
one shared no-op singleton — no span objects, no event dicts, no clock
reads.  Call sites guard bulk work with ``if tracer.enabled:``.

With no clock injected the tracer runs on a **logical clock** (one
microsecond per read): ordering is preserved and two identical runs
produce byte-identical traces.  Pass ``clock=time.perf_counter`` when real
latencies matter (benchmarks, serving).
"""

from __future__ import annotations

import json
from typing import Callable, Mapping

#: Keys every exported Chrome trace event carries (the validator and the
#: CI obs leg check these).
CHROME_REQUIRED_KEYS = ("name", "ph", "ts", "pid", "tid")


class _NullSpan:
    """Shared no-op span: context manager + ``add`` sink."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def add(self, **args) -> None:
        pass


_NULL_SPAN = _NullSpan()


class NullTracer:
    """Disabled tracer: every operation is a no-op, nothing is allocated."""

    enabled = False

    def now(self) -> float:
        return 0.0

    def span(self, name, **kw) -> _NullSpan:
        return _NULL_SPAN

    def complete(self, name, ts, dur, **kw) -> None:
        pass

    def instant(self, name, **kw) -> None:
        pass


NULL_TRACER = NullTracer()


class _Span:
    """Live span handle: context manager recording a complete event."""

    __slots__ = ("_tracer", "name", "worker", "stream", "cat", "args",
                 "_start")

    def __init__(self, tracer, name, worker, stream, cat, args):
        self._tracer = tracer
        self.name = name
        self.worker = worker
        self.stream = stream
        self.cat = cat
        self.args = args
        self._start = 0.0

    def add(self, **args) -> None:
        """Attach key/value payload to the span (shows in Perfetto args)."""
        self.args.update(args)

    def __enter__(self):
        self._start = self._tracer.now()
        return self

    def __exit__(self, exc_type, exc, tb):
        end = self._tracer.now()
        if exc_type is not None:
            self.args.setdefault("error", exc_type.__name__)
        self._tracer.complete(
            self.name, self._start, end - self._start, worker=self.worker,
            stream=self.stream, cat=self.cat, args=self.args,
        )
        return False


class Tracer:
    """Span/event recorder.  ``clock`` is injected; ``None`` selects the
    deterministic logical clock (1 µs per read)."""

    enabled = True

    def __init__(self, clock: Callable[[], float] | None = None):
        self._clock = clock
        self._tick = 0
        # Raw events: ts/dur in SECONDS (converted to µs on export).
        self.events: list[dict] = []

    # -- time ----------------------------------------------------------------

    def now(self) -> float:
        if self._clock is not None:
            return float(self._clock())
        self._tick += 1
        return self._tick * 1e-6

    # -- recording ------------------------------------------------------------

    def span(self, name: str, *, worker: int = 0, stream: str = "main",
             cat: str = "", **args) -> _Span:
        """Open a nestable span (use as a context manager)."""
        return _Span(self, name, worker, stream, cat, dict(args))

    def complete(self, name: str, ts: float, dur: float, *,
                 worker: int = 0, stream: str = "main", cat: str = "",
                 args: Mapping | None = None) -> None:
        """Record a closed interval at an explicit timestamp (the
        simulator's path — its event loop knows start and duration)."""
        self.events.append({
            "name": str(name), "ph": "X", "ts": float(ts),
            "dur": max(0.0, float(dur)), "pid": int(worker),
            "stream": str(stream), "cat": str(cat),
            "args": dict(args or {}),
        })

    def instant(self, name: str, *, ts: float | None = None, worker: int = 0,
                stream: str = "main", cat: str = "",
                args: Mapping | None = None) -> None:
        """Record a zero-duration marker (faults, evictions, deaths)."""
        self.events.append({
            "name": str(name), "ph": "i",
            "ts": self.now() if ts is None else float(ts),
            "pid": int(worker), "stream": str(stream), "cat": str(cat),
            "args": dict(args or {}),
        })

    # -- export ----------------------------------------------------------------

    def _stream_tids(self) -> dict[tuple[int, str], int]:
        """Stable stream-name → tid mapping, per pid, sorted by name."""
        per_pid: dict[int, set[str]] = {}
        for e in self.events:
            per_pid.setdefault(e["pid"], set()).add(e["stream"])
        tids: dict[tuple[int, str], int] = {}
        for pid in sorted(per_pid):
            for i, stream in enumerate(sorted(per_pid[pid])):
                tids[(pid, stream)] = i
        return tids

    def to_chrome(self) -> dict:
        """Chrome trace-event representation (``{"traceEvents": [...]}``)."""
        tids = self._stream_tids()
        out: list[dict] = []
        for pid in sorted({pid for pid, _ in tids}):
            out.append({
                "name": "process_name", "ph": "M", "ts": 0.0, "pid": pid,
                "tid": 0, "args": {"name": f"worker{pid}"},
            })
        for (pid, stream), tid in sorted(tids.items()):
            out.append({
                "name": "thread_name", "ph": "M", "ts": 0.0, "pid": pid,
                "tid": tid, "args": {"name": stream},
            })
        body = []
        for seq, e in enumerate(self.events):
            ev = {
                "name": e["name"], "ph": e["ph"],
                "ts": round(e["ts"] * 1e6, 3), "pid": e["pid"],
                "tid": tids[(e["pid"], e["stream"])],
                "cat": e["cat"] or "default",
            }
            if e["ph"] == "X":
                ev["dur"] = round(e["dur"] * 1e6, 3)
            if e["ph"] == "i":
                ev["s"] = "t"  # thread-scoped instant
            if e["args"]:
                ev["args"] = e["args"]
            body.append((ev["ts"], ev["pid"], ev["tid"], seq, ev))
        body.sort(key=lambda t: t[:4])
        out.extend(ev for *_k, ev in body)
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def to_json(self) -> str:
        """Deterministic Chrome trace JSON (sorted keys, stable order)."""
        return json.dumps(self.to_chrome(), sort_keys=True,
                          separators=(",", ":"))

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    def text_timeline(self, width: int = 64) -> str:
        """Plain-text timeline: one lane per (worker, stream), ``#`` where
        the lane is busy, with per-lane busy/wall accounting."""
        spans = [e for e in self.events if e["ph"] == "X"]
        if not spans:
            return "(empty trace)"
        t0 = min(e["ts"] for e in spans)
        t1 = max(e["ts"] + e["dur"] for e in spans)
        wall = max(t1 - t0, 1e-12)
        lanes: dict[tuple[int, str], list[dict]] = {}
        for e in spans:
            lanes.setdefault((e["pid"], e["stream"]), []).append(e)
        lines = [f"timeline: {wall:.6g}s wall, {len(spans)} spans, "
                 f"{len(lanes)} lanes"]
        for (pid, stream) in sorted(lanes):
            cells = [" "] * width
            busy = 0.0
            for e in sorted(lanes[(pid, stream)], key=lambda e: e["ts"]):
                busy += e["dur"]
                lo = int((e["ts"] - t0) / wall * (width - 1))
                hi = int((e["ts"] + e["dur"] - t0) / wall * (width - 1))
                for i in range(lo, hi + 1):
                    cells[i] = "#"
            lines.append(
                f"w{pid}/{stream:<8s} |{''.join(cells)}| "
                f"busy {busy:.6g}s ({busy / wall * 100.0:.0f}%)"
            )
        return "\n".join(lines)


__all__ = [
    "CHROME_REQUIRED_KEYS", "NULL_TRACER", "NullTracer", "Tracer",
]

"""A slice of a traced run under ``torch.profiler``, and its reading.

The harness marks each application (``app``), each ``Context.launch`` call
(``launch:<kernel>``) and the wait at its end (``sync``) with
``record_function``, so that the profiler's timeline carries them beside
the device's operations.  The slice runs from the start of its first
application to the end of its last; its reading gives:

* ``busy_s``: the union of the device's operations (kernels, copies and
  fills) within the slice, and ``window_s`` the slice's length;
* ``ops``: every device operation in the slice as (name, seconds);
* ``device_ops``: the ten names that took most device time, summed;
* ``idle_gaps``: the device's idle time within the slice summed by the
  innermost annotation open on the host when each gap began, ten largest.
"""

from __future__ import annotations

import json
import os
import tempfile

import torch

#: chrome-trace categories of operations that run on the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: entries of each breakdown list
TOP = 10


def activities() -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def warm_up() -> None:
    """Starts and stops the profiler once around a small device operation,
    so that its first start (CUPTI's set-up) falls in set-up."""
    with torch.profiler.profile(activities=activities()):
        x = torch.ones(8, device="cuda" if torch.cuda.is_available()
                       else "cpu")
        (x + 1).sum().item()


class Slice:
    """``start()`` before the slice's first application, ``stop()`` after
    its last; ``stop`` returns the reading."""

    def __init__(self):
        self._prof = None

    def start(self) -> None:
        self._prof = torch.profiler.profile(activities=activities())
        self._prof.start()

    def stop(self) -> dict:
        self._prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.remove(path)
        self._prof = None
        return read(events)


def _union(intervals: list[tuple[float, float]]) -> list[list[float]]:
    out: list[list[float]] = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def _label(t: float, notes: list[tuple[float, float, str]]) -> str:
    """The innermost annotation open at ``t`` (the latest to start)."""
    best = None
    for lo, hi, name in notes:
        if lo <= t < hi and (best is None or lo >= best[0]):
            best = (lo, name)
    return best[1] if best else "none"


def read(events: list[dict]) -> dict:
    """The reading of a slice's chrome-trace events (times in us)."""
    notes = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
              str(e["name"])) for e in events
             if e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    apps = [(lo, hi) for lo, hi, name in notes if name == "app"]
    if not apps:
        return {"busy_s": 0.0, "window_s": 0.0, "ops": [], "apps": 0,
                "device_ops": [], "idle_gaps": []}
    t0, t1 = min(lo for lo, _ in apps), max(hi for _, hi in apps)
    ops = [(str(e["name"]), float(e["ts"]), float(e.get("dur", 0.0)))
           for e in events
           if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"]
    ops = [(n, ts, d) for n, ts, d in ops if ts < t1 and ts + d > t0]
    busy = _union([(max(ts, t0), min(ts + d, t1)) for _, ts, d in ops])
    by_name: dict[str, float] = {}
    for name, _, d in ops:
        by_name[name] = by_name.get(name, 0.0) + d * 1e-6
    gaps: dict[str, float] = {}
    edge = t0
    for lo, hi in busy + [[t1, t1]]:
        if lo > edge:
            label = _label(edge, notes)
            gaps[label] = gaps.get(label, 0.0) + (lo - edge) * 1e-6
        edge = max(edge, hi)

    def top(d: dict) -> list:
        return [[k[:160], v] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return {"busy_s": sum(hi - lo for lo, hi in busy) * 1e-6,
            "window_s": (t1 - t0) * 1e-6,
            "ops": [(n, d * 1e-6) for n, _, d in ops],
            "apps": len(apps), "device_ops": top(by_name),
            "idle_gaps": top(gaps)}

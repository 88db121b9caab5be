"""Runs one cell once and prints its result.

    python3 lightning_bench/run.py --workload <name> --seed <n> \\
        --seconds <s> --trace <0|1>

One process on one card, or, where the traffic's placement is ``ranks``,
one process a rank (``repro_torch.dist.ranks.spawn``, NCCL, a card each)
whose readings this process combines.  The last line of standard output
is the result, one JSON object; the last lines of standard error give each
number compared beside its limit.  Without the cards the cell asks for, or
with JAX or the JAX package loaded once the window has closed, it prints
no result and exits with another code than 0.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys

import torch

from lightning_bench.harness import bench, session

#: seconds a rank of a spawned run may take in all
RANKS_TIMEOUT_S = 330.0


def run_cell(root: str, workload: str, seed: int, seconds: float,
             trace: bool, t_process: float, device: str = "cuda",
             sizes: dict | None = None, mix: dict | None = None,
             fault=None) -> tuple[dict, list]:
    """(the result, forbidden modules found in this process or a rank).
    ``sizes``, ``mix`` and ``fault`` are for tests: sizes over the
    configuration's, parameters over the traffic's, and a function that
    plants a fault in the application's module."""
    cell = bench.cell(root, workload)
    spec = session.Spec(root, workload, seed, seconds, trace, sizes, mix,
                        fault)
    traffic = {**cell.traffic, **(mix or {})}
    if traffic["placement"] == "ranks":
        from repro_torch.dist import ranks

        rs = ranks.spawn(session.rank_main, traffic["ranks"],
                         device=None if device == "cuda" else device,
                         args=(spec,), timeout=RANKS_TIMEOUT_S)
    else:
        rs = [session.run(spec, torch.device(
            "cuda", 0) if device == "cuda" else torch.device(device))]
    found = sorted(set(session.forbidden_modules()).union(
        *(r.forbidden for r in rs)))
    return result(cell, rs, t_process, trace, device), found


def result(cell: bench.Cell, rs: list, t_process: float, trace: bool,
           device: str) -> dict:
    peak = None if rs[0].peak_bytes is None else max(r.peak_bytes
                                                     for r in rs)
    whole = dataclasses.replace(rs[0], peak_bytes=peak,
                                setup_s=rs[0].setup_end - t_process)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        read = bench.metric(m["name"]).read
        if trace:
            vals = [v for v in map(read, rs) if v is not None]
            value = statistics.fmean(vals) if vals else None
        else:
            value = read(whole)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks: dict = {}
    for r in rs:
        for name, (value, limit) in r.checks.items():
            if name not in checks or not value <= checks[name]["value"]:
                checks[name] = {"value": value, "limit": limit}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    out = {
        "correct": correct, "attempted": len(rs[0].apps),
        "failed": max(r.failed for r in rs), "metrics": metrics,
        "device": {"platform": "gpu" if device == "cuda" else device,
                   "kind": rs[0].kind, "count": len(rs),
                   "memory_peak_bytes": peak},
    }
    if trace:
        slices = [r.device for r in rs if r.device]
        out["device"]["busy_s"] = statistics.fmean(
            s["busy_s"] for s in slices) if slices else 0.0
        out["device"]["window_s"] = statistics.fmean(
            s["window_s"] for s in slices) if slices else 0.0
        if slices:
            out["breakdown"] = {"device_ops": slices[0]["device_ops"],
                                "idle_gaps": slices[0]["idle_gaps"]}
    apps = sorted(rs[0].apps)
    tenth = max(1, len(apps) // 10)
    out["app_s"] = {"min": apps[0], "median": statistics.median(apps),
                    "max": apps[-1],
                    "first_tenth": statistics.fmean(rs[0].apps[:tenth]),
                    "last_tenth": statistics.fmean(rs[0].apps[-tenth:])}
    ph = dict(rs[0].phases)
    ph["start"] = ph.pop("session_start") - t_process
    out["seconds"] = ph
    out["checks"] = checks
    return out


def main(argv: list[str], t_process: float, root: str) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = bench.cell(root, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out, found = run_cell(root, args.workload, args.seed, args.seconds,
                          bool(args.trace), t_process)
    if found:
        print("modules of JAX or of the JAX package were loaded: "
              + ", ".join(found), file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(out), flush=True)
    return 0

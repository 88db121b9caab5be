"""Runs one cell several times, one process a run, and sums up the spread.

    python3 lightning_bench/sets.py --workload <name> --seeds 1,2,3 \\
        --seconds 30 [--trace 0] [--sets 2] [--out runs.jsonl]

Each set runs every seed once, in order; the sets repeat the same seeds.
Every run's result line (or its exit code and the end of its standard
error) is appended to ``--out`` as one JSON object; then for each set and
each metric the median and the spread, the distance between the first and
third quartile as Python's ``statistics.quantiles(values, n=4)`` gives
them, as a share of the median.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def one(workload: str, seed: int, seconds: float, trace: int) -> dict:
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "run.py"), "--workload",
         workload, "--seed", str(seed), "--seconds", str(seconds),
         "--trace", str(trace)], cwd=ROOT, capture_output=True, text=True)
    rec = {"workload": workload, "seed": seed, "trace": trace,
           "rc": proc.returncode, "wall_s": time.time() - t0,
           "stderr_tail": proc.stderr[-1500:]}
    lines = proc.stdout.strip().splitlines()
    if proc.returncode == 0 and lines:
        rec["result"] = json.loads(lines[-1])
    return rec


def spread(values: list[float]) -> tuple[float, float]:
    """(median, (q3 - q1) / median)."""
    med = statistics.median(values)
    if len(values) < 2:
        return med, 0.0
    q1, _, q3 = statistics.quantiles(values, n=4)
    return med, (q3 - q1) / med if med else 0.0


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--sets", type=int, default=1)
    p.add_argument("--out", default=None)
    args = p.parse_args()
    seeds = [int(s) for s in args.seeds.split(",")]
    runs = []
    for k in range(args.sets):
        for seed in seeds:
            rec = one(args.workload, seed, args.seconds, args.trace)
            rec["set"] = k
            runs.append(rec)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
            res = rec.get("result", {})
            print(json.dumps({"set": k, "seed": seed, "rc": rec["rc"],
                              "wall_s": round(rec["wall_s"], 1),
                              "correct": res.get("correct"),
                              "metrics": {m: v["value"] for m, v in
                                          res.get("metrics", {}).items()},
                              "checks": {c: v["value"] for c, v in
                                         res.get("checks", {}).items()}}),
                  flush=True)
            if rec["rc"]:
                print(rec["stderr_tail"], flush=True)
    for k in range(args.sets):
        done = [r["result"] for r in runs if r["set"] == k and "result" in r]
        names = sorted({m for r in done for m in r["metrics"]})
        for m in names:
            vals = [r["metrics"][m]["value"] for r in done
                    if m in r["metrics"]]
            med, sp = spread(vals)
            print(f"set {k} {m}: median {med!r} spread {sp!r} "
                  f"({len(vals)} runs)")
    return 0 if all(r["rc"] == 0 and r["result"]["correct"]
                    for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main())

"""Tiny sizes of the cells for the tests on the CPU."""

import os
import time

from lightning_bench.harness.cell import run_cell

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SIZES = {"kmeans": {"n_points": 1 << 14},
         "hotspot": {"rows": 64, "cols": 96}}
#: the ranks traffic at 2 ranks (gloo on the CPU)
TWO_RANKS = {"placement": "ranks", "ranks": 2, "scale": "weak"}


def run(workload: str, trace: bool = False, mix=None, fault=None,
        seconds: float = 0.3, seed: int = 2**31 + 11) -> dict:
    out, found = run_cell(ROOT, workload, seed, seconds, trace, time.time(),
                          device="cpu", sizes=SIZES[workload.split(".")[0]],
                          mix=mix, fault=fault)
    assert not found, found
    return out

"""The control of a cell: its plain reference put in the program's place
and computed in bfloat16, the nearest precision below the configuration's
f32, at the cell's own size, judged by the cell's own comparison.

    python3 lightning_bench/control.py --workload <name> --seeds 1,2,3

It prints each seed's numbers beside their limits, and exits with 0 only
where the control fails a limit on every seed, as it has to.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main() -> int:
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch

    from lightning_bench.harness import bench

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args()
    cell = bench.cell(ROOT, args.workload)
    world = cell.traffic.get("ranks", 1)
    device = torch.device("cuda", 0)
    failed_all = True
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        gaps = cell.app.control(cell.config, cell.traffic, seed, device,
                                world)
        fails = [k for k, v in gaps.items()
                 if not v <= cell.reference.LIMITS[k]]
        failed_all &= bool(fails)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": gaps, "limits": cell.reference.LIMITS,
                          "fails": fails, "seconds": time.time() - t0}),
              flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())

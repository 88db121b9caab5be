"""Runs one cell of the benchmark once (see ``harness/cell.py``):

    python3 lightning_bench/run.py --workload <name> --seed <n> \\
        --seconds <s> --trace <0|1>

from the root of a checkout.  The program's kernels are built into
``build/repro_torch/`` in the checkout at their first use, and any other
cache of the run goes under ``build/`` there too, at fixed paths.
"""

import os
import sys
import time

T_PROCESS = time.time()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

if __name__ == "__main__":
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(ROOT, "build", "lightning_bench", sub)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    from lightning_bench.harness.cell import main

    sys.exit(main(sys.argv[1:], T_PROCESS, ROOT))

"""The paper's spilling experiment, end to end: K-Means over host-resident
data streamed through the GPU in double-buffered chunks (§3.4 / Fig. 12).

Data lives in host memory (the "spilled" tier); only two chunks are ever
resident on the device.  The host-to-device copies run on their own stream
and overlap the assignment kernel like the paper's memory-manager pipeline.

Run:  PYTHONPATH=src python -m repro_torch.examples.streaming_kmeans [--mb 512]
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.core.streaming import stream_kmeans
from repro_torch.device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mb", type=int, default=128,
                    help="dataset size in MB (host-resident)")
    ap.add_argument("--chunk-rows", type=int, default=1 << 18)
    ap.add_argument("--clusters", type=int, default=40)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="torch device; the GPU when omitted")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    f = 4
    n = args.mb * (1 << 20) // (f * 4)
    rng = np.random.RandomState(0)
    print(f"generating {n:,} records ({args.mb} MB) in host memory ...")
    centers = rng.rand(args.clusters, f).astype(np.float32) * 10
    pts = (centers[rng.randint(0, args.clusters, n)]
           + rng.randn(n, f).astype(np.float32) * 0.25)

    cen = torch.from_numpy(pts[rng.choice(n, args.clusters, replace=False)])
    for it in range(args.iters):
        t0 = time.perf_counter()
        cen = stream_kmeans(pts, cen, chunk_rows=args.chunk_rows,
                            device=device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        print(f"iter {it}: {dt:6.2f}s  "
              f"{pts.nbytes / dt / 1e9:.2f} GB/s streamed  "
              f"({n / dt / 1e6:.1f} Mrec/s)")

    # recovered centroids should sit near true centers
    d = np.sqrt(((cen.cpu().numpy()[:, None] - centers[None]) ** 2).sum(-1))
    print(f"median distance to nearest true center: "
          f"{np.median(d.min(axis=1)):.3f} (noise σ=0.25)")


if __name__ == "__main__":
    main()

"""The paper's full application (section 4.6): CGC geospatial co-clustering.

Generates a synthetic space x time matrix with planted co-cluster
structure, runs Bregman block-average co-clustering one iteration at a time
with ``kernels.coclustering.ref.coclustering_iteration_ref``, and reports
the recovered structure and each iteration's time (the paper's throughput
= matrix bytes / iteration time).  The matrix, the planted clusters and the
starting assignments are the reference example's, made with numpy from
seed 0.  On the GPU unless ``--device`` names another device.

Run:  PYTHONPATH=src python -m repro_torch.examples.coclustering
      [--rows 4096] [--cols 512] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.coclustering.ref import coclustering_iteration_ref


def planted(rows: int, cols: int, r: int, c: int):
    """(z, row truth, col truth, starting row and col assignments): the
    reference example's draws from ``np.random.RandomState(0)``, in its
    order."""
    rng = np.random.RandomState(0)
    row_gt = rng.randint(0, r, rows)
    col_gt = rng.randint(0, c, cols)
    means = rng.rand(r, c) * 5 + 0.5
    z = (means[row_gt][:, col_gt]
         * (1 + 0.05 * rng.randn(rows, cols))).astype(np.float32)
    z = np.abs(z)
    ra = rng.randint(0, r, rows).astype(np.int32)
    ca = rng.randint(0, c, cols).astype(np.int32)
    return z, row_gt, col_gt, ra, ca


def purity(assign: np.ndarray, gt: np.ndarray, k: int) -> float:
    """Cluster agreement by best-match purity."""
    total = 0
    for c in range(k):
        members = gt[assign == c]
        if len(members):
            total += np.bincount(members, minlength=k).max()
    return total / len(gt)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(rows: int, cols: int, r: int, c: int, iters: int,
        device: torch.device | str | None = None) -> dict:
    """The example's iterations; returns the final assignments, the
    purities and each iteration's seconds."""
    device = resolve_device(device)
    z, row_gt, col_gt, ra, ca = planted(rows, cols, r, c)
    zt = torch.from_numpy(z).to(device)
    rat = torch.from_numpy(ra).to(device)
    cat = torch.from_numpy(ca).to(device)
    print(f"device: {device}")
    print(f"matrix {rows}×{cols} ({z.nbytes / 1e6:.1f} MB), "
          f"{r}×{c} co-clusters, {iters} iterations")
    coclustering_iteration_ref(zt, rat, cat, r, c)  # warm-up
    sync(device)
    seconds = []
    for it in range(iters):
        t0 = time.perf_counter()
        rat, cat = coclustering_iteration_ref(zt, rat, cat, r, c)
        sync(device)
        dt = time.perf_counter() - t0
        seconds.append(dt)
        new_ra, new_ca = rat.cpu().numpy(), cat.cpu().numpy()
        moved = int((new_ra != ra).sum() + (new_ca != ca).sum())
        ra, ca = new_ra, new_ca
        print(f"iter {it}: {dt * 1e3:7.1f} ms  "
              f"throughput {z.nbytes / dt / 1e9:.2f} GB/s  moved={moved}")
    out = {"rows": ra, "cols": ca, "seconds": seconds,
           "row_purity": purity(ra, row_gt, r),
           "col_purity": purity(ca, col_gt, c)}
    print(f"row purity: {out['row_purity']:.3f}  "
          f"col purity: {out['col_purity']:.3f}")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=2048)
    ap.add_argument("--cols", type=int, default=512)
    ap.add_argument("--row-clusters", type=int, default=8)
    ap.add_argument("--col-clusters", type=int, default=6)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device; the GPU when omitted")
    args = ap.parse_args(argv)
    run(args.rows, args.cols, args.row_clusters, args.col_clusters,
        args.iters, args.device)


if __name__ == "__main__":
    main()

"""Quickstart: the paper's Fig. 9 host-code example on one GPU.

A 1-D stencil kernel with a data annotation, launched 10 times over a
distributed array with buffer swapping — the planner infers the halo
exchange and the cross-launch dependencies automatically.  With
``--workers k`` the same code runs over a mesh of k workers (on the one
device), each launch's superblocks one worker at a time, each worker's
view its shard with a one-cell halo from its neighbours, as the
reference's quickstart does when it sees more than one device.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
      [--workers 4]
"""

import argparse

import torch

from repro_torch.core import BlockWork, Context, KernelDef, StencilDist


def stencil_body(views, info):
    """The 3-point mean on the view with a cell of each neighbour on either
    side; the whole array (one worker) gets the zeros that the end shards
    of a mesh receive."""
    x = views["input"]
    if x.shape[0] == info.grid[0]:
        zero = torch.zeros((1,), dtype=x.dtype, device=x.device)
        x = torch.cat([zero, x, zero])
    return {"output": (x[:-2] + x[1:-1] + x[2:]) / 3.0}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device; the GPU when omitted")
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--workers", type=int, default=1,
                    help="workers of a 1-D mesh on the device")
    args = ap.parse_args(argv)

    # Mirror of paper Fig. 9: kernel definition with a data annotation.
    stencil = KernelDef.define(
        "stencil",
        stencil_body,
        "global i => read input[i-1:i+1], write output[i]",
    )

    ctx = Context(device=args.device, num_workers=args.workers)
    print(f"device: {ctx.device}")
    print(f"workers: {ctx.num_devices}")

    n = args.n
    data_dist = StencilDist(n // args.workers, 1)  # chunk + halo of 1
    work_dist = BlockWork(n // args.workers)

    inp = ctx.ones((n,), dist=data_dist, name="input")
    out = ctx.zeros((n,), dist=data_dist, name="output")

    for _ in range(10):
        res = ctx.launch(
            stencil, grid=(n,), work_dist=work_dist,
            args={"input": inp, "output": out},
        )
        inp, out = res["output"], inp  # swap, like the paper's host loop

    ctx.synchronize(inp)
    rec = ctx.records[-1]
    print("result[0:4]      :", inp.to_numpy()[:4])
    print("comm per argument:", {k: v.value for k, v in rec.comm.items()})
    print("plan tasks       :", rec.plan.plan.counts())
    print("launches recorded:", len(ctx.records))


if __name__ == "__main__":
    main()

"""Quickstart: the paper's Fig. 9 host-code example on one GPU.

A 1-D stencil kernel with a data annotation, launched 10 times over a
distributed array with buffer swapping — the planner infers the halo
exchange and the cross-launch dependencies automatically.  With
``--workers k`` the same code runs over a mesh of k workers (on the one
device), each launch's superblocks one worker at a time, each worker's
view its shard with a one-cell halo from its neighbours, as the
reference's quickstart does when it sees more than one device.  With
``--ranks k`` it runs in each of k ``torch.distributed`` ranks
(``ranks.spawn``; gloo on the CPU, and on a machine with fewer cards than
ranks), each rank holding only its own shard and receiving its halo
cells from its neighbours' processes, as the reference's quickstart
distributes over ``jax.devices()``; rank 0's lines are printed.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
      [--workers 4 | --ranks 4]
"""

import argparse

import torch

from repro_torch.core import BlockWork, Context, KernelDef, StencilDist
from repro_torch.dist import ranks
from repro_torch.launch.mesh import make_mesh, spawn_backend


def stencil_body(views, info):
    """The 3-point mean on the view with a cell of each neighbour on either
    side; the whole array (one worker) gets the zeros that the end shards
    of a mesh receive."""
    x = views["input"]
    if x.shape[0] == info.grid[0]:
        zero = torch.zeros((1,), dtype=x.dtype, device=x.device)
        x = torch.cat([zero, x, zero])
    return {"output": (x[:-2] + x[1:-1] + x[2:]) / 3.0}


def fig9(ctx: Context, n: int) -> list[str]:
    """The ten launches of Fig. 9 on ``ctx``; the lines to print."""
    # Mirror of paper Fig. 9: kernel definition with a data annotation.
    stencil = KernelDef.define(
        "stencil",
        stencil_body,
        "global i => read input[i-1:i+1], write output[i]",
    )
    k = ctx.num_devices
    data_dist = StencilDist(n // k, 1)  # chunk + halo of 1
    work_dist = BlockWork(n // k)

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
    return [f"device: {ctx.device}",
            f"workers: {ctx.num_devices}",
            f"result[0:4]      : {inp.to_numpy()[:4]}",
            f"comm per argument: {({k: v.value for k, v in rec.comm.items()})}",
            f"plan tasks       : {rec.plan.plan.counts()}",
            f"launches recorded: {len(ctx.records)}"]


def rank_fig9(device, n: int, world: int) -> list[str]:
    """Fig. 9 in one rank of ``world``, over a rank mesh ``("data",)``."""
    return fig9(Context(mesh=make_mesh((world,), ("data",)), device=device),
                n)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device; the GPU when omitted")
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--workers", type=int, default=1,
                    help="workers of a 1-D mesh on the device")
    ap.add_argument("--ranks", type=int, default=0,
                    help="torch.distributed ranks, one process each")
    args = ap.parse_args(argv)

    if args.ranks:
        if args.workers != 1:
            ap.error("give --workers or --ranks, not both")
        backend, device = spawn_backend(args.device, args.ranks)
        lines = ranks.spawn(rank_fig9, args.ranks, backend=backend,
                            device=device, args=(args.n, args.ranks))[0]
    else:
        lines = fig9(Context(device=args.device, num_workers=args.workers),
                     args.n)
    for line in lines:
        print(line)


if __name__ == "__main__":
    main()

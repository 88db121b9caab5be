"""Quickstart: the paper's Fig. 9 host-code example on one GPU.

A 1-D stencil kernel with a data annotation, launched 10 times over a
distributed array with buffer swapping — the planner infers the halo
exchange and the cross-launch dependencies automatically.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

import argparse

import torch

from repro_torch.core import BlockWork, Context, KernelDef, StencilDist


def stencil_body(views, info):
    x = views["input"]
    zero = torch.zeros((1,), dtype=x.dtype, device=x.device)
    left = torch.cat([zero, x[:-1]])
    right = torch.cat([x[1:], zero])
    return {"output": (left + x + right) / 3.0}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device; the GPU when omitted")
    ap.add_argument("--n", type=int, default=1_000_000)
    args = ap.parse_args(argv)

    # Mirror of paper Fig. 9: kernel definition with a data annotation.
    stencil = KernelDef.define(
        "stencil",
        stencil_body,
        "global i => read input[i-1:i+1], write output[i]",
    )

    ctx = Context(device=args.device)
    print(f"device: {ctx.device}")

    n = args.n
    data_dist = StencilDist(n, 1)  # chunk + halo of 1
    work_dist = BlockWork(n)

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

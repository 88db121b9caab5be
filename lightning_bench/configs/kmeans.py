"""K-Means as a Lightning user writes it (Rodinia 3.1 ``kmeans``).

The annotated kernel and its body are ``chip_smoke.py``'s ``KMEANS_DEF``
and ``kmeans_body``, frozen here: each launch assigns every point to its
nearest centroid and reduces the sums and counts by cluster (REDUCE), and
an application is ``iterations`` launches, each followed by the centroid
update, ended by ``ctx.synchronize()``.

Placements (the traffic's ``placement``):

* ``resident`` and ``ranks``: the points live on the card(s), written by an
  initialising launch whose body draws each worker's rows from the seed
  (on a rank mesh every rank draws only its own shard);
* ``host``: the points live in pageable host memory and every iteration
  streams them through the card in chunks of ``chunk_rows`` rows
  (``stream_kmeans``).
"""

from __future__ import annotations

import torch

from repro_torch.core import BlockWork, KernelDef, ReplicatedDist, RowDist
from repro_torch.core.streaming import stream_kmeans
from repro_torch.kernels import kmeans_assign_reduce
from repro_torch.kernels.kmeans.kernel import kmeans_cuda

from lightning_bench.reference import kmeans as ref


def kmeans_body(views, info):
    sums, counts = kmeans_assign_reduce(views["points"], views["centroids"])
    return {"sums": sums, "counts": counts}


def init_body(views, info):
    """Writes a worker's rows of the points, drawn from the seed."""
    lo = info.thread_offset[0]
    centre = info.scalars["centre"]
    device = views["points"].device
    return {"points": ref.draw_points(info.scalars["seed"], lo,
                                      lo + info.local_shape[0], centre,
                                      device)}


KMEANS_DEF = KernelDef.define(
    "kmeans", kmeans_body,
    "global i => read points[i,:], read centroids[:,:], "
    "reduce(+) sums[:,:], reduce(+) counts[:]")
INIT_DEF = KernelDef.define(
    "kmeans_init", init_body, "global i => write points[i,:]",
    scalars=("seed", "centre"))

#: what the timed path's launches must show (``ctx.records[-1].comm``)
PATTERNS = {"resident": {"points": "local", "centroids": "replicated",
                         "sums": "reduce", "counts": "reduce"},
            "ranks": {"points": "local", "centroids": "replicated",
                      "sums": "reduce", "counts": "reduce"}}
#: every launch of the CUDA kernel takes this route at these shapes
ROUTE = "private"
#: every application's results are judged (kept in host memory)
KEEP_EVERY = True


def points_of(params: dict, world: int, traffic: dict) -> int:
    """Points over all the cards: the configuration's, times the ranks
    where the traffic scales weakly."""
    n = params["n_points"]
    return n * world if traffic.get("scale") == "weak" else n


def place(ctx, params: dict, traffic: dict, seed: int, world: int):
    k, f = params["clusters"], params["features"]
    centre, start = ref.centres(seed, k, f)
    n = points_of(params, world, traffic)
    if traffic["placement"] == "host":
        points = ref.draw_points(seed, 0, n, centre, ctx.device)
        return {"points": points.cpu().numpy(), "start": start.to(ctx.device)}
    w = ctx.num_devices
    points = ctx.zeros((n, f), dist=RowDist(w), name="points")
    points = ctx.launch(INIT_DEF, grid=(n,), work_dist=BlockWork(n // w),
                        scalars={"seed": seed, "centre": centre},
                        args={"points": points})["points"]
    return {"points": points,
            "sums": ctx.zeros((k, f), dist=ReplicatedDist(), name="sums"),
            "counts": ctx.zeros((k,), dist=ReplicatedDist(), name="counts"),
            "start": start.to(ctx.device)}


def run_app(ctx, state: dict, params: dict, traffic: dict) -> list:
    """One application: ``iterations`` launches, each followed by the
    centroid update; each iteration's counts, sums and new centroids (the
    new centroids alone when streamed)."""
    cen = state["start"]
    trace = []
    if traffic["placement"] == "host":
        for _ in range(params["iterations"]):
            cen = stream_kmeans(state["points"], cen,
                                chunk_rows=traffic["chunk_rows"],
                                device=ctx.device)
            trace.append({"centroids": cen})
        ctx.synchronize()
        return trace
    points, n = state["points"], state["points"].shape[0]
    w = ctx.num_devices
    for _ in range(params["iterations"]):
        res = ctx.launch(
            KMEANS_DEF, grid=(n,), work_dist=BlockWork(n // w),
            args={"points": points,
                  "centroids": ctx.array(cen, name="centroids"),
                  "sums": state["sums"], "counts": state["counts"]})
        cnt, tot = res["counts"].value, res["sums"].value
        cen = tot / cnt.clamp(min=1.0)[:, None]
        trace.append({"counts": cnt, "sums": tot, "centroids": cen})
    ctx.synchronize()
    return trace


def launches_per_app(params: dict, traffic: dict, world: int) -> int:
    """The CUDA kernel's launches an application, on each card."""
    if traffic["placement"] == "host":
        n = points_of(params, world, traffic)
        return params["iterations"] * -(-n // traffic["chunk_rows"])
    return params["iterations"]


def launch_counters() -> tuple[int, dict]:
    return kmeans_cuda.launches, dict(kmeans_cuda.routes)


def work(params: dict, traffic: dict, world: int) -> dict:
    """Operations and bytes on each card, from the problem's shapes: an
    assignment of n points of f features to k clusters is
    n k (2f + 3) + 2 n f operations (a distance is f subtractions, f
    multiplications and f - 1 additions, then a comparison and a select
    for each of the k clusters with the running minimum, 2f + 2, rounded
    up to 2f + 3 with the index; the sums f additions a point and the
    count one, 2 n f counted as in PERF.md's kernel table), and n f 4 bytes
    of points read once.  The application is ``iterations`` of them; the
    centroid updates (k f divisions) are left out."""
    n = points_of(params, world, traffic) // world
    k, f = params["clusters"], params["features"]
    ops = n * k * (2 * f + 3) + 2 * n * f
    nbytes = 4 * (n * f + k * f + k * f + k)
    it = params["iterations"]
    return {"app": (it * ops, it * nbytes),
            "kernels": {"kmeans": {"match": "kmeans_", "ops": ops,
                                   "bytes": nbytes}}}


def kept(result: list) -> list:
    """An application's result as the judge reads it, in host memory: one
    copy from the card, made after its synchronize, so that the card's
    peak holds no application's results."""
    vals = [v.detach() for it in result for v in it.values()]
    flat = torch.cat([v.reshape(-1) for v in vals]).cpu()
    parts = iter(torch.split(flat, [v.numel() for v in vals]))
    return [{k: next(parts).reshape(v.shape).to(v.dtype)
             for k, v in it.items()} for it in result]


def judge(results: list, params: dict, traffic: dict, seed: int, device,
          world: int, rank: int, dtype=torch.float64) -> list[dict]:
    """Each kept application's iterations against the reference's (the
    same for every application, each starting from the same centroids):
    ``ref.gaps`` of each."""
    n = points_of(params, world, traffic)
    want = ref.iterations(seed, n, params["clusters"], params["features"],
                          params["iterations"], dtype, device)
    return [ref.gaps(got, want) for got in results]


def control(params: dict, traffic: dict, seed: int, device,
            world: int) -> dict:
    """The control's gaps at the cell's size."""
    return ref.control(params, points_of(params, world, traffic), seed,
                       device)

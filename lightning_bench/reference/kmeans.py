"""Plain reference of the K-Means cells, and the draw of their inputs.

K-Means (Rodinia 3.1 ``kmeans``): each iteration assigns every point to
its nearest centroid by squared distance, sums the points and counts them
by cluster, and takes each cluster's mean as its new centroid (a cluster
with no point keeps a count of 1, as the application divides).

The points lie around ``clusters`` centres picked from the lattice
{0, 3, 6}^f, each within 0.5 of its centre in every feature, so no point
lies near a bisector and the counts compare exactly.  They are drawn in
blocks of ``POINT_BLOCK`` rows, each from a generator seeded by the run's
seed and the block's index, so that any run of rows is drawn alike
wherever it is drawn.  This module is plain PyTorch: it imports nothing of
the program under test.
"""

from __future__ import annotations

import torch

#: points a block of the draw
POINT_BLOCK = 1 << 20
#: points the reference assigns at a time
REF_BLOCK = 1 << 21


def block_seed(seed: int, block: int) -> int:
    """The generator seed of point block ``block`` of a run seeded ``seed``."""
    return (int(seed) << 20) + int(block)


def centres(seed: int, clusters: int, features: int) -> torch.Tensor:
    """(centres, start centroids), f32 on the CPU: ``clusters`` lattice
    points, no two closer than 3, and each moved by up to 0.2 in every
    feature for the first iteration."""
    gen = torch.Generator().manual_seed(int(seed))
    grid = torch.cartesian_prod(*[torch.tensor([0.0, 3.0, 6.0])] * features)
    if features == 1:
        grid = grid[:, None]
    if clusters > grid.shape[0]:
        raise ValueError(f"{clusters} clusters need more than the "
                         f"{grid.shape[0]} lattice points of {features} "
                         "features")
    centre = grid[torch.randperm(grid.shape[0], generator=gen)[:clusters]]
    jitter = torch.rand(centre.shape, generator=gen)
    return centre, centre + 0.4 * (jitter - 0.5)


def draw_points(seed: int, p0: int, p1: int, centre: torch.Tensor,
                device) -> torch.Tensor:
    """Points [p0, p1), (p1 - p0, f) f32 on ``device``."""
    k, f = centre.shape
    centre = centre.to(device)
    out = torch.empty((p1 - p0, f), dtype=torch.float32, device=device)
    gen = torch.Generator(device=device)
    for b in range(p0 // POINT_BLOCK, -(-p1 // POINT_BLOCK)):
        gen.manual_seed(block_seed(seed, b))
        which = torch.randint(0, k, (POINT_BLOCK,), generator=gen,
                              device=device)
        pts = torch.rand((POINT_BLOCK, f), generator=gen, device=device)
        pts.sub_(0.5).add_(centre[which])
        lo, hi = max(p0, b * POINT_BLOCK), min(p1, (b + 1) * POINT_BLOCK)
        out[lo - p0:hi - p0] = pts[lo - b * POINT_BLOCK:hi - b * POINT_BLOCK]
    return out


def iterations(seed: int, n: int, clusters: int, features: int, iters: int,
               dtype: torch.dtype, device) -> list[dict]:
    """Each iteration's ``counts`` (k,), ``sums`` (k, f) and new
    ``centroids`` (k, f), the points drawn once in f32 and every step in
    ``dtype`` but the counts, which are integers."""
    centre, cen = centres(seed, clusters, features)
    cen = cen.to(device=device, dtype=dtype)
    points = draw_points(seed, 0, n, centre, device)
    out = []
    for _ in range(iters):
        sums = torch.zeros((clusters, features), dtype=dtype, device=device)
        counts = torch.zeros((clusters,), dtype=torch.int64, device=device)
        for p0 in range(0, n, REF_BLOCK):
            x = points[p0:p0 + REF_BLOCK].to(dtype)
            d = ((x[:, None, :] - cen[None, :, :]) ** 2).sum(dim=2)
            near = d.argmin(dim=1)
            sums.index_add_(0, near, x)
            counts += torch.bincount(near, minlength=clusters)
        cen = sums / counts.clamp(min=1).to(dtype)[:, None]
        out.append({"counts": counts, "sums": sums, "centroids": cen})
    return out


def control(params: dict, n: int, seed: int, device) -> dict:
    """The control: the reference computed in bfloat16, the nearest
    precision below the configuration's f32, judged as the program is."""
    args = (seed, n, params["clusters"], params["features"],
            params["iterations"])
    return gaps(iterations(*args, torch.bfloat16, device),
                iterations(*args, torch.float64, device))


def gaps(got: list[dict], want: list[dict]) -> dict:
    """Over the iterations (each a dict as ``iterations`` gives, any of
    its three keys present): the largest difference of a count, and the
    widest gap of a sum and of a centroid as a share of the largest |sum|
    and |centroid| of the reference's iteration (a coordinate of a sum
    near a lattice centre at 0 is near 0 itself)."""
    out = {"counts_off": 0.0, "sums_gap": 0.0, "centroid_gap": 0.0}
    if len(got) != len(want):
        return dict.fromkeys(out, float("inf"))
    names = {"counts": "counts_off", "sums": "sums_gap",
             "centroids": "centroid_gap"}
    for g_it, w_it in zip(got, want):
        for key, name in names.items():
            if key not in g_it:
                continue
            g = g_it[key].double().cpu()
            w = w_it[key].double().cpu()
            if g.shape != w.shape or not torch.isfinite(g).all():
                out[name] = float("inf")
                continue
            diff = float((g - w).abs().max())
            if key != "counts":
                diff /= max(float(w.abs().max()), 1e-30)
            out[name] = max(out[name], diff)
    return out


#: the limit of each number compared (PERF.md gives the readings each was
#: set from); a count is exact
LIMITS = {"counts_off": 0.0, "sums_gap": 1e-3, "centroid_gap": 1e-3}

"""Launches for ``tests/test_torch_launch_ranks.py``, run alike by the
one-controller ``Context`` on a mesh of workers and, in each of 4 gloo
ranks (``repro_torch.dist.ranks.spawn``), by ``Context`` on a rank mesh.

A rank imports the function it runs by module; this one imports only
torch, numpy and the port (never JAX or the reference).  Every case takes
its inputs from one dict of numpy arrays and returns numpy arrays and
plain values, so that the test compares the two runs, and the
reference's, case by case.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

import repro_torch.core as T
from repro_torch.dist import ranks
from repro_torch.kernels import hotspot_step
from repro_torch.launch.mesh import make_mesh

STENCIL = "global i => read input[i-1:i+1], write output[i]"
GEMM = "global [i, j] => read A[i,:], read B[:,j], write C[i,j]"
HOTSPOT = ("global [i, j] => read temp[i-1:i+1, j-1:j+1], read power[i,j], "
           "write out[i,j]")
SCALE = "global i => read x[i], read w[:], write y[i]"
OPS = {"sum": ("+", torch.sum), "min": ("min", torch.amin),
       "max": ("max", torch.amax), "prod": ("*", torch.prod)}


def inputs(seed: int = 0) -> dict:
    rng = np.random.RandomState(seed)
    return {"x": rng.rand(512).astype(np.float32),
            "a": rng.rand(64, 48).astype(np.float32),
            "b": rng.rand(48, 64).astype(np.float32),
            "r": (0.9 + 0.2 * rng.rand(96, 24)).astype(np.float32),
            "w": rng.rand(16).astype(np.float32),
            "temp": (rng.rand(64, 40) * 10 + 320).astype(np.float32),
            "power": (rng.rand(64, 40) * 0.5).astype(np.float32)}


def rows_over_all_axes():
    """Rows split over every mesh axis (a spec entry naming them all), so
    that each worker holds distinct rows on a (2, 2) mesh too."""
    return T.CustomDist(fn=lambda shape, nd: T.RowDist().chunks(shape, nd),
                        spec_fn=lambda axes: (tuple(axes), None))


def record(ctx) -> dict:
    r = ctx.records[-1]
    return {"comm": {k: v.value for k, v in r.comm.items()},
            "in_specs": {k: list(v) for k, v in r.in_specs.items()},
            "out_specs": {k: list(v) for k, v in r.out_specs.items()},
            "tasks": r.plan.plan.counts()}


def stencil_body(views, info):
    """The 1-D stencil on a halo'd view (zeros at the end shards)."""
    x = views["input"]
    return {"output": (x[:-2] + x[1:-1] + x[2:]) / 3.0}


def hotspot_padded_body(views, info):
    """HotSpot as the reference's multi-device test writes it: the halo'd
    slab (zero rows at the ends) and power padded by a zero row."""
    p = torch.nn.functional.pad(views["power"], (0, 0, 1, 1))
    return {"out": hotspot_step(views["temp"], p)[1:-1]}


def hotspot_trimmed_body(views, info):
    """The body a CUDA user writes: the zero halo row at either end of the
    grid dropped, so that the kernel's own clamp applies there (the whole
    grid on one worker)."""
    slab, p = views["temp"], views["power"]
    if slab.shape[0] == info.grid[0]:
        return {"out": hotspot_step(slab, p)}
    top = info.thread_offset[0] == 0
    bottom = info.thread_offset[0] + info.local_shape[0] == info.grid[0]
    slab = slab[int(top): slab.shape[0] - int(bottom)]
    pad = p.new_zeros((1, p.shape[1]))
    p = torch.cat([pad] * (not top) + [p] + [pad] * (not bottom))
    out = hotspot_step(slab.contiguous(), p)
    return {"out": out[int(not top): out.shape[0] - int(not bottom)]}


def run_cases(ctx, inp: dict) -> dict:
    """Every case on ``ctx``: outputs (whole, by ``to_numpy``), records,
    and the shapes of the values this context holds."""
    k = ctx.num_devices
    out, recs, held = {}, {}, {}
    n = inp["x"].shape[0]

    # the Fig. 9 stencil, three launches with buffer swap
    kd = T.KernelDef.define("stencil", stencil_body, STENCIL)
    a = ctx.array(inp["x"], dist=T.StencilDist(n // k, 1), name="input")
    b = ctx.zeros((n,), dist=T.StencilDist(n // k, 1), name="output")
    held["stencil_input"] = tuple(a.value.shape)
    for _ in range(3):
        res = ctx.launch(kd, grid=(n,), work_dist=T.BlockWork(n // k),
                         args={"input": a, "output": b})
        a, b = res["output"], a
    out["stencil"], recs["stencil"] = a.to_numpy(), record(ctx)
    held["stencil_output"] = tuple(a.value.shape)
    held["stencil_global"] = a.shape

    # GEMM, B gathered by rows
    m = inp["a"].shape[0]
    kd = T.KernelDef.define("gemm", lambda v, i: {"C": v["A"] @ v["B"]},
                            GEMM)
    for tag, b_dist in (("gemm", T.RowDist()),
                        ("gemm_b_all_axes", rows_over_all_axes())):
        res = ctx.launch(kd, grid=(m, m), args={
            "A": ctx.array(inp["a"], dist=T.RowDist(), name="A"),
            "B": ctx.array(inp["b"], dist=b_dist, name="B"),
            "C": ctx.zeros((m, m), dist=T.RowDist(), name="C")})
        out[tag], recs[tag] = res["C"].to_numpy(), record(ctx)

    # column reductions, rows split over every mesh axis
    rows, cols = inp["r"].shape
    for tag, (op, fn) in OPS.items():
        kd = T.KernelDef.define(
            "col" + tag, lambda v, i, f=fn: {"s": f(v["A"], dim=0)},
            f"global [i, j] => read A[i,j], reduce({op}) s[j]")
        A = ctx.array(inp["r"], dist=rows_over_all_axes(), name="A")
        held["colreduce_A"] = tuple(A.value.shape)
        res = ctx.launch(kd, grid=(rows, cols), args={
            "A": A, "s": ctx.zeros((cols,), dist=T.ReplicatedDist(),
                                   name="s")})
        out["col" + tag], recs["col" + tag] = res["s"].to_numpy(), \
            record(ctx)

    # LOCAL and REPLICATED arguments
    kd = T.KernelDef.define("scale",
                            lambda v, i: {"y": v["x"] * v["w"].sum()}, SCALE)
    res = ctx.launch(kd, grid=(n,), work_dist=T.BlockWork(n // k), args={
        "x": ctx.array(inp["x"], dist=T.BlockDist(n // k), name="x"),
        "w": ctx.array(inp["w"], name="w"),
        "y": ctx.zeros((n,), dist=T.BlockDist(n // k), name="y")})
    out["scale"], recs["scale"] = res["y"].to_numpy(), record(ctx)

    # HotSpot: the reference's padded body, and on a 1-D mesh (where a
    # superblock is its slab) the trimmed one
    rows, cols = inp["temp"].shape
    bodies = [("hotspot", hotspot_padded_body)]
    if len(ctx.mesh_axes) == 1:
        bodies.append(("hotspot_trimmed", hotspot_trimmed_body))
    for tag, body in bodies:
        kd = T.KernelDef.define("hotspot", body, HOTSPOT)
        res = ctx.launch(kd, grid=(rows, cols),
                         work_dist=T.BlockWork(rows // k), args={
            "temp": ctx.array(inp["temp"], dist=T.StencilDist(rows // k, 1),
                              name="temp"),
            "power": ctx.array(inp["power"], dist=T.BlockDist(rows // k),
                               name="power"),
            "out": ctx.zeros((rows, cols), dist=T.StencilDist(rows // k, 1),
                             name="out")})
        out[tag], recs[tag] = res["out"].to_numpy(), record(ctx)

    try:
        ctx.array(np.ones(1001, np.float32), dist=T.RowDist(), name="odd")
        recs["uneven_raises"] = False
    except ValueError:
        recs["uneven_raises"] = True
    return {"out": out, "records": recs, "held": held}


def fault_case(ctx) -> dict:
    """A launch whose first two attempts are injected failures."""
    kd = T.KernelDef.define("double", lambda v, i: {"y": v["x"] * 2.0},
                            "global i => read x[i], write y[i]")
    x = ctx.array(np.arange(64, dtype=np.float32), dist=T.BlockDist(16),
                  name="x")
    res = ctx.launch(kd, grid=(64,), work_dist=T.BlockWork(16), args={
        "x": x, "y": ctx.zeros((64,), dist=T.BlockDist(16), name="y")})
    return {"y": res["y"].to_numpy(),
            "events": [(e["kind"], e["attempt"]) for e in ctx.fault_events]}


def fault_injector():
    return T.FaultInjector([T.fail_launch(at=0, times=2)], seed=0)


def fault_policy():
    return T.RecoveryPolicy(max_attempts=2)


def suite(device, shape: tuple, axes: tuple, inp: dict) -> dict:
    """One rank's run of every case on a rank mesh of ``shape``."""
    mesh = make_mesh(shape, axes)
    got = run_cases(T.Context(mesh=mesh, device=device), inp)

    got["fault"] = fault_case(T.Context(
        mesh=mesh, device=device, fault_injector=fault_injector(),
        recovery=fault_policy()))

    # a real exception on one rank propagates there without a retry
    def failing(v, info):
        if info.device_index == 1:
            raise ZeroDivisionError("a real failure")
        return {"y": v["x"] + 1.0}

    ctx = T.Context(mesh=mesh, device=device,
                    fault_injector=T.FaultInjector([], seed=0))
    kd = T.KernelDef.define("fails", failing,
                            "global i => read x[i], write y[i]")
    try:
        ctx.launch(kd, grid=(64,), work_dist=T.BlockWork(16), args={
            "x": ctx.array(np.zeros(64, np.float32), dist=T.BlockDist(16),
                           name="x"),
            "y": ctx.zeros((64,), dist=T.BlockDist(16), name="y")})
        got["real_failure"] = None
    except ZeroDivisionError:
        got["real_failure"] = list(ctx.fault_events)
    ranks.barrier()

    # a rank mesh with no device given takes the rank's card
    real = torch.cuda.is_available
    torch.cuda.is_available = lambda: False
    try:
        T.Context(mesh=mesh)
        got["no_card_raises"] = False
    except RuntimeError as exc:
        got["no_card_raises"] = "no CUDA device" in str(exc)
    finally:
        torch.cuda.is_available = real

    with ranks.use_mesh(mesh):
        me = dist.get_rank()
        got["pmin"] = ranks.pmin(torch.tensor([100 - me, me, -(2 ** 40) * me],
                                              dtype=torch.int64),
                                 axes).tolist()
        got["tiled"] = ranks.all_gather_tiled(
            torch.full((2, 1), me, dtype=torch.int64), axes, 0)[:, 0].tolist()
        got["axis_index"] = ranks.axis_index(axes)
    return got

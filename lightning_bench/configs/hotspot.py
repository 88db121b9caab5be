"""HotSpot as a Lightning user writes it (Rodinia 3.1 ``hotspot``).

The annotated kernel and its body are ``chip_smoke.py``'s ``HOTSPOT_DEF``
and ``halo_hotspot_body``, frozen here: each launch takes one step of the
thermal stencil, reading each worker's slab with one halo row of its
neighbours on either side (HALO) and writing its own rows (LOCAL).  An
application is ``steps`` launches with the buffers swapped, ended by
``ctx.synchronize()``.

Placements (the traffic's ``placement``): ``resident`` and ``ranks``, the
grids on the card(s), written by an initialising launch whose body draws
each worker's rows from the seed (on a rank mesh every rank draws only its
own slab).
"""

from __future__ import annotations

import json
import os

import torch

from repro_torch.core import BlockDist, BlockWork, KernelDef, StencilDist
from repro_torch.kernels import hotspot_step
from repro_torch.kernels.stencil2d.kernel import hotspot_cuda

from lightning_bench.reference import hotspot as ref

with open(os.path.join(os.path.dirname(__file__), "hotspot.json")) as _f:
    #: the thermal constants the configuration states
    CONSTANTS = json.load(_f)["constants"]


def halo_hotspot_body(views, info):
    """One HotSpot step on a worker's slab: the halo row at either end of
    the grid (zeros) is dropped so that the kernel's own clamp applies
    there, the neighbours' rows are kept for the stencil and their outputs
    dropped; power (LOCAL) is padded to the slab.  On one worker the slab
    is the whole grid."""
    slab, power = views["temp"], views["power"]
    if slab.shape[0] == info.grid[0]:
        return {"out": hotspot_step(slab, power, **CONSTANTS)}
    top = info.thread_offset[0] == 0
    bottom = info.thread_offset[0] + info.local_shape[0] == info.grid[0]
    slab = slab[int(top): slab.shape[0] - int(bottom)]
    pad = power.new_zeros((1, power.shape[1]))
    power = torch.cat([pad] * (not top) + [power] + [pad] * (not bottom))
    out = hotspot_step(slab.contiguous(), power, **CONSTANTS)
    return {"out": out[int(not top): out.shape[0] - int(not bottom)]}


def init_body(views, info):
    """Writes a worker's rows of the temperature and the power, drawn from
    the seed."""
    lo = info.thread_offset[0]
    temp, power = ref.draw_rows(info.scalars["seed"], lo,
                                lo + info.local_shape[0], info.grid[1],
                                views["temp"].device)
    return {"temp": temp, "power": power}


HOTSPOT_DEF = KernelDef.define(
    "hotspot", halo_hotspot_body,
    "global [i, j] => read temp[i-1:i+1, j-1:j+1], read power[i,j], "
    "write out[i,j]")
INIT_DEF = KernelDef.define(
    "hotspot_init", init_body,
    "global [i, j] => write temp[i,j], write power[i,j]", scalars=("seed",))

#: what the timed path's launches must show (``ctx.records[-1].comm``):
#: one worker reads its whole grid, so its halo is LOCAL
PATTERNS = {"resident": {"temp": "local", "power": "local", "out": "local"},
            "ranks": {"temp": "halo", "power": "local", "out": "local"}}
#: the kernel has one route
ROUTE = None
#: only the last application's grid is kept (4 GiB a grid)
KEEP_EVERY = False


def shape_of(params: dict, world: int, traffic: dict) -> tuple[int, int]:
    """The whole grid: the configuration's, with its rows times the ranks
    where the traffic scales weakly."""
    rows, cols = params["rows"], params["cols"]
    return (rows * world if traffic.get("scale") == "weak" else rows, cols)


def place(ctx, params: dict, traffic: dict, seed: int, world: int):
    rows, cols = shape_of(params, world, traffic)
    slab = rows // ctx.num_devices
    temp = ctx.zeros((rows, cols), dist=StencilDist(slab, 1), name="temp")
    power = ctx.zeros((rows, cols), dist=BlockDist(slab), name="power")
    res = ctx.launch(INIT_DEF, grid=(rows, cols), work_dist=BlockWork(slab),
                     scalars={"seed": seed},
                     args={"temp": temp, "power": power})
    return {"temp": res["temp"], "power": res["power"],
            "out": ctx.zeros((rows, cols), dist=StencilDist(slab, 1),
                             name="out")}


def run_app(ctx, state: dict, params: dict, traffic: dict):
    """One application: ``steps`` launches, buffers swapped; the final
    grid (a rank's slab of it on a rank mesh)."""
    rows, cols = state["temp"].shape
    slab = rows // ctx.num_devices
    temp, power, nxt = state["temp"], state["power"], state["out"]
    for _ in range(params["steps"]):
        res = ctx.launch(HOTSPOT_DEF, grid=(rows, cols),
                         work_dist=BlockWork(slab),
                         args={"temp": temp, "power": power, "out": nxt})
        temp, nxt = res["out"], temp
    ctx.synchronize()
    return temp


def launches_per_app(params: dict, traffic: dict, world: int) -> int:
    return params["steps"]


def launch_counters() -> tuple[int, dict]:
    return hotspot_cuda.launches, {}


def work(params: dict, traffic: dict, world: int) -> dict:
    """Bytes and operations on each card, from the problem's shapes: a
    step reads temp and power once and writes the new temp once, 12 bytes
    a cell, and takes 14 operations a cell (2c; two neighbour sums, each
    less 2c and scaled, 6; (amb - c) rz, 2; three additions and the
    power; the update's scale and add, 2)."""
    rows, cols = shape_of(params, world, traffic)
    cells = rows // world * cols
    steps = params["steps"]
    return {"app": (steps * 14 * cells, steps * 12 * cells),
            "kernels": {"hotspot": {"match": "hotspot_kernel",
                                    "ops": 14 * cells, "bytes": 12 * cells}}}


def kept(result) -> torch.Tensor:
    """The final grid as the judge reads it: this card's rows, on the
    card."""
    return result.value


def judge(results: list, params: dict, traffic: dict, seed: int, device,
          world: int, rank: int, dtype=torch.float64) -> list[dict]:
    """The last application's grid (this rank's rows of it) against the
    reference's rows after the same steps."""
    rows, cols = shape_of(params, world, traffic)
    got = results[-1]
    r0 = rank * (rows // world)
    want = ref.final_rows(seed, r0, r0 + got.shape[0], rows, cols,
                          params["steps"], params["constants"], dtype, device)
    return [ref.gaps(got, want)]


def control(params: dict, traffic: dict, seed: int, device,
            world: int) -> dict:
    """The control's gaps at the cell's size: the rows of one card (an
    interior rank's over ranks)."""
    rows, _ = shape_of(params, world, traffic)
    slab = rows // world
    r0 = slab * (world // 2)
    return ref.control(params, r0, r0 + slab, rows, seed, device)

"""Plain reference of the HotSpot cells, and the draw of their inputs.

HotSpot (Rodinia 3.1 ``hotspot``) is the thermal RC stencil.  One step of
the 5-point update on a rows x cols grid, each out-of-grid neighbour the
cell itself (zero flux at the edge):

    T'[i,j] = T + sdc * ((T[i,j-1] + T[i,j+1] - 2 T) * rx
                         + (T[i-1,j] + T[i+1,j] - 2 T) * ry
                         + (amb - T) * rz + P[i,j])

The constants are Rodinia 3.1's for the grid's size (``rodinia_constants``),
with which the explicit scheme is stable.  The inputs are drawn in blocks
of ``ROW_BLOCK`` rows, each from a generator seeded by the run's seed and
the block's index, so that any run of rows (one card's slab, or the rows a
reference needs around it) is drawn alike wherever it is drawn.  This
module is plain PyTorch: it imports nothing of the program under test.
"""

from __future__ import annotations

import torch

#: rows a block of the draw
ROW_BLOCK = 1024
#: rows the reference steps at a time
STEP_BLOCK = 2048


def block_seed(seed: int, block: int) -> int:
    """The generator seed of row block ``block`` of a run seeded ``seed``."""
    return (int(seed) << 20) + int(block)


def draw_rows(seed: int, r0: int, r1: int, cols: int,
              device) -> tuple[torch.Tensor, torch.Tensor]:
    """Rows [r0, r1) of the initial temperature (320 to 350) and of the
    power (0 to 0.25), f32 on ``device``."""
    temp = torch.empty((r1 - r0, cols), dtype=torch.float32, device=device)
    power = torch.empty_like(temp)
    gen = torch.Generator(device=device)
    for b in range(r0 // ROW_BLOCK, -(-r1 // ROW_BLOCK)):
        gen.manual_seed(block_seed(seed, b))
        u = torch.rand((2, ROW_BLOCK, cols), generator=gen, device=device)
        lo, hi = max(r0, b * ROW_BLOCK), min(r1, (b + 1) * ROW_BLOCK)
        src = slice(lo - b * ROW_BLOCK, hi - b * ROW_BLOCK)
        temp[lo - r0:hi - r0] = 320.0 + 30.0 * u[0, src]
        power[lo - r0:hi - r0] = 0.25 * u[1, src]
    return temp, power


def rodinia_constants(chip: dict, rows: int, cols: int) -> dict:
    """The scheme's scalars as Rodinia 3.1's ``compute_tran_temp``
    (``hotspot_openmp.cpp``) derives them for a ``rows`` x ``cols`` grid on
    its chip: sdc = step / Cap, rx = 1 / Rx, ry = 1 / Ry, rz = 1 / Rz."""
    gh, gw = chip["chip_height"] / rows, chip["chip_width"] / cols
    t, k = chip["t_chip"], chip["k_si"]
    cap = chip["factor_chip"] * chip["spec_heat_si"] * t * gw * gh
    max_slope = chip["max_pd"] / (chip["factor_chip"] * t
                                  * chip["spec_heat_si"])
    step_s = chip["precision"] / max_slope / 1000.0
    return {"sdc": step_s / cap, "rx": 2.0 * k * t * gh / gw,
            "ry": 2.0 * k * t * gw / gh, "rz": k * gh * gw / t,
            "amb": chip["amb_temp"]}


def step(t: torch.Tensor, p: torch.Tensor, c: dict) -> torch.Tensor:
    """One step of the whole of ``t`` (clamped at its own first and last
    rows and columns), in ``t``'s dtype, ``STEP_BLOCK`` rows at a time."""
    rows = t.shape[0]
    out = torch.empty_like(t)
    for r0 in range(0, rows, STEP_BLOCK):
        r1 = min(rows, r0 + STEP_BLOCK)
        i = torch.arange(r0, r1, device=t.device)
        centre = t[r0:r1]
        up = t.index_select(0, (i - 1).clamp(min=0))
        down = t.index_select(0, (i + 1).clamp(max=rows - 1))
        left = torch.cat([centre[:, :1], centre[:, :-1]], dim=1)
        right = torch.cat([centre[:, 1:], centre[:, -1:]], dim=1)
        delta = c["sdc"] * ((left + right - 2.0 * centre) * c["rx"]
                            + (up + down - 2.0 * centre) * c["ry"]
                            + (c["amb"] - centre) * c["rz"] + p[r0:r1])
        out[r0:r1] = centre + delta
    return out


def final_rows(seed: int, r0: int, r1: int, rows: int, cols: int,
               steps: int, consts: dict, dtype: torch.dtype,
               device) -> torch.Tensor:
    """Rows [r0, r1) of a ``rows`` x ``cols`` grid after ``steps`` steps,
    computed in ``dtype``.  A row after s steps depends only on the rows
    within s of it, so the reference draws ``steps`` rows more on either
    side (fewer at the grid's own edges, where it clamps as the grid
    does) and keeps the middle."""
    e0, e1 = max(0, r0 - steps), min(rows, r1 + steps)
    temp, power = draw_rows(seed, e0, e1, cols, device)
    t, p = temp.to(dtype), power.to(dtype)
    del temp, power
    for _ in range(steps):
        t = step(t, p, consts)
    return t[r0 - e0:r1 - e0]


def control(params: dict, r0: int, r1: int, rows: int, seed: int,
            device) -> dict:
    """The control: the reference's rows [r0, r1) computed in bfloat16,
    the nearest precision below the configuration's f32, judged as the
    program is."""
    args = (seed, r0, r1, rows, params["cols"], params["steps"],
            params["constants"])
    return gaps(final_rows(*args, torch.bfloat16, device),
                final_rows(*args, torch.float64, device))


def gaps(got: torch.Tensor, want: torch.Tensor) -> dict:
    """``grid_gap``: the widest gap between ``got`` and ``want``;
    ``mean_gap``: the gap between their means, which every term that moves
    each cell alike shifts (the ambient's, about 1e-6 here) while
    rounding does not.  Both as shares of the largest |want|."""
    if got.shape != want.shape:
        return {"grid_gap": float("inf"), "mean_gap": float("inf")}
    worst, scale, diff = 0.0, 0.0, 0.0
    for r0 in range(0, want.shape[0], STEP_BLOCK):
        w = want[r0:r0 + STEP_BLOCK].double()
        g = got[r0:r0 + STEP_BLOCK].to(w.device).double()
        if not torch.isfinite(g).all():
            return {"grid_gap": float("inf"), "mean_gap": float("inf")}
        worst = max(worst, float((g - w).abs().max()))
        scale = max(scale, float(w.abs().max()))
        diff += float((g - w).sum())
    scale = scale or 1.0
    return {"grid_gap": worst / scale,
            "mean_gap": abs(diff) / want.numel() / scale}


#: the limit of each number compared (PERF.md gives the readings each was
#: set from)
LIMITS = {"grid_gap": 1e-4, "mean_gap": 1e-8}

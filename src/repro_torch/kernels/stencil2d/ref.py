"""Plain PyTorch version of the HotSpot thermal stencil (Rodinia; paper §4.2).

One step of the 5-point thermal update on a rows×cols grid:

    T'[i,j] = T[i,j] + step/cap * ( (T[i,j-1] + T[i,j+1] - 2 T[i,j]) / Rx
                                  + (T[i-1,j] + T[i+1,j] - 2 T[i,j]) / Ry
                                  + (Tamb     -             T[i,j]) / Rz
                                  + P[i,j] )

Boundary cells clamp to their own value for out-of-grid neighbours
(zero-flux boundary, matching Rodinia's guarded loads).
"""

from __future__ import annotations

import torch

# Rodinia-like constants folded to scalars.
DEFAULTS = dict(sdc=0.3412, rx=1.0 / 0.2, ry=1.0 / 0.2, rz=1.0 / 4.75,
                amb=80.0)


def hotspot_step_ref(
    temp: torch.Tensor,
    power: torch.Tensor,
    *,
    sdc: float = DEFAULTS["sdc"],
    rx: float = DEFAULTS["rx"],
    ry: float = DEFAULTS["ry"],
    rz: float = DEFAULTS["rz"],
    amb: float = DEFAULTS["amb"],
) -> torch.Tensor:
    t = temp
    up = torch.cat([t[:1, :], t[:-1, :]], dim=0)
    down = torch.cat([t[1:, :], t[-1:, :]], dim=0)
    left = torch.cat([t[:, :1], t[:, :-1]], dim=1)
    right = torch.cat([t[:, 1:], t[:, -1:]], dim=1)
    delta = sdc * (
        (left + right - 2.0 * t) * rx
        + (up + down - 2.0 * t) * ry
        + (amb - t) * rz
        + power
    )
    return t + delta

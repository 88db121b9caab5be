"""Public wrapper for the HotSpot stencil kernel."""

from __future__ import annotations

import torch

from .kernel import hotspot_cuda
from .ref import DEFAULTS, hotspot_step_ref


def hotspot_step(
    temp: torch.Tensor,
    power: torch.Tensor,
    *,
    block_rows: int = 256,
    use_ref: bool = False,
    **consts,
) -> torch.Tensor:
    """One HotSpot step.  On a CUDA tensor this launches the hand-written
    kernel, which clamps at the array edge itself, so no row is padded; a
    CPU tensor (or ``use_ref=True``) takes the plain version.  ``block_rows``
    is accepted for the reference's signature; the kernel has its own
    tile."""
    del block_rows
    consts = {**DEFAULTS, **consts}
    if use_ref or temp.device.type == "cpu":
        return hotspot_step_ref(temp, power, **consts)
    return hotspot_cuda(temp, power, **consts)

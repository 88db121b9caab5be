"""Public wrappers for the N-Body kernel."""

from __future__ import annotations

import torch

from .kernel import nbody_cuda
from .ref import SOFTENING2, nbody_forces_ref, nbody_step_ref


def nbody_forces(
    posm: torch.Tensor,
    *,
    block_i: int = 1024,
    block_j: int = 1024,
    softening2: float = SOFTENING2,
    use_ref: bool = False,
) -> torch.Tensor:
    """Accelerations (n, 3).  On a CUDA tensor this launches the
    hand-written kernel, which fills its last source tile with zero-mass
    bodies in shared memory, so nothing is padded; a CPU tensor (or
    ``use_ref=True``) takes the plain version.  ``block_i`` and ``block_j``
    are accepted for the reference's signature; the kernel has its own
    tile."""
    del block_i, block_j
    if use_ref or posm.device.type == "cpu":
        return nbody_forces_ref(posm, softening2)
    return nbody_cuda(posm, softening2=softening2)


def nbody_step(
    posm: torch.Tensor,
    vel: torch.Tensor,
    dt: float = 0.01,
    **kw,
) -> tuple[torch.Tensor, torch.Tensor]:
    if kw.pop("use_ref", False):
        return nbody_step_ref(posm, vel, dt)
    acc = nbody_forces(posm, **kw)
    vel = vel + dt * acc
    pos = posm[:, :3] + dt * vel
    return torch.cat([pos, posm[:, 3:]], dim=1), vel

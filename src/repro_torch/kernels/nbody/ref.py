"""Plain PyTorch version of the N-Body benchmark (CUDA samples; paper §4.2).

All-pairs gravitational interaction with Plummer softening:

    a_i = Σ_j  m_j * (p_j − p_i) / (|p_j − p_i|² + ε²)^{3/2}

Positions are (n, 4): xyz + mass (the CUDA sample's float4 layout).
"""

from __future__ import annotations

import torch

SOFTENING2 = 1e-3

#: elements of the (targets, n, 3) difference tensor per slab of targets:
#: 1.6 GB in f32 whatever n is (1024 targets at n = 2**17)
SLAB_ELEMENTS = 3 << 27


def nbody_forces_ref(
    posm: torch.Tensor,
    softening2: float = SOFTENING2,
    *,
    rows: tuple[int, int] | None = None,
    cols: tuple[int, int] | None = None,
) -> torch.Tensor:
    """Accelerations (n, 3), or those of the targets ``rows = (lo, hi)``
    only, from every source or from the sources ``cols = (lo, hi)`` only.
    Targets are taken in slabs so that the (targets, sources, 3)
    intermediate stays at ``SLAB_ELEMENTS``."""
    n = posm.shape[0]
    lo, hi = rows if rows is not None else (0, n)
    src = posm[slice(*cols)] if cols is not None else posm
    pos, mass = src[:, :3], src[:, 3]
    slab = max(1, SLAB_ELEMENTS // max(1, 3 * src.shape[0]))
    out = []
    for a in range(lo, hi, slab):
        b = min(hi, a + slab)
        d = pos[None, :, :] - posm[a:b, None, :3]  # (i, j, 3): p_j - p_i
        dist2 = torch.sum(d * d, dim=-1) + softening2
        inv_d3 = torch.rsqrt(dist2) / dist2  # 1 / dist^3
        out.append(torch.einsum("ij,ijk->ik", mass[None, :] * inv_d3, d))
    if not out:
        return posm.new_zeros((0, 3))
    return torch.cat(out) if len(out) > 1 else out[0]


def nbody_slices(n: int, slices: int, tile: int) -> list[tuple[int, int]]:
    """The source ranges of route "tile": at most ``slices`` of them, each
    a whole number of ``tile`` sources but the last, in order."""
    length = -(-max(1, -(-n // slices)) // tile) * tile
    return [(lo, min(n, lo + length)) for lo in range(0, n, length)]


def nbody_sliced_ref(
    posm: torch.Tensor,
    softening2: float = SOFTENING2,
    *,
    slices: int,
    tile: int,
) -> torch.Tensor:
    """Accelerations (n, 3) summed as route "tile" sums them: each slice of
    sources (``nbody_slices``) on its own, then the slices' partials added
    in slice order."""
    parts = [nbody_forces_ref(posm, softening2, cols=c)
             for c in nbody_slices(posm.shape[0], slices, tile)]
    if not parts:
        return posm.new_zeros((0, 3))
    acc = parts[0]
    for part in parts[1:]:
        acc = acc + part
    return acc


def nbody_step_ref(
    posm: torch.Tensor,
    vel: torch.Tensor,
    dt: float = 0.01,
    softening2: float = SOFTENING2,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Leapfrog-ish Euler step used by the sample (positions, velocities)."""
    acc = nbody_forces_ref(posm, softening2)
    vel = vel + dt * acc
    pos = posm[:, :3] + dt * vel
    return torch.cat([pos, posm[:, 3:]], dim=1), vel

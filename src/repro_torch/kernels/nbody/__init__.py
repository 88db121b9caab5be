from .ops import nbody_forces, nbody_step
from .ref import nbody_forces_ref, nbody_sliced_ref, nbody_step_ref

__all__ = ["nbody_forces", "nbody_step", "nbody_forces_ref",
           "nbody_sliced_ref", "nbody_step_ref"]

from .ops import hotspot_step
from .ref import hotspot_step_ref

__all__ = ["hotspot_step", "hotspot_step_ref"]

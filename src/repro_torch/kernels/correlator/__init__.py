from .ops import correlate
from .ref import correlate_ref

__all__ = ["correlate", "correlate_ref"]

from .ops import black_scholes
from .ref import black_scholes_ref

__all__ = ["black_scholes", "black_scholes_ref"]

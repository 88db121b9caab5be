from .ops import rg_lru
from .ref import rg_lru_chunked_ref, rg_lru_ref

__all__ = ["rg_lru", "rg_lru_chunked_ref", "rg_lru_ref"]

from .ops import md5_search
from .ref import md5_search_ref, md5_u32x2

__all__ = ["md5_search", "md5_search_ref", "md5_u32x2"]

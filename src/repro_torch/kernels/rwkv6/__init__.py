from .ops import wkv6
from .ref import wkv6_chunked_ref, wkv6_ref

__all__ = ["wkv6", "wkv6_chunked_ref", "wkv6_ref"]

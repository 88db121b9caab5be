from .ops import gemm
from .ref import gemm_ref

__all__ = ["gemm", "gemm_ref"]

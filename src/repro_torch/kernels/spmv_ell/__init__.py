from .ops import spmv_ell
from .ref import spmv_ell_ref

__all__ = ["spmv_ell", "spmv_ell_ref"]

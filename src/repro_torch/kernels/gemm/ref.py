"""Plain PyTorch version of the GEMM benchmark (paper §4.2, Volkov-style)."""

from __future__ import annotations

import torch


def gemm_ref(a: torch.Tensor, b: torch.Tensor,
             out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """C = A @ B with f32 accumulation.  Set
    ``torch.backends.cuda.matmul.allow_tf32 = False`` (PyTorch's default)
    where this stands as the reference for f32 inputs on a GPU."""
    out_dtype = out_dtype or a.dtype
    return torch.matmul(a.to(torch.float32), b.to(torch.float32)).to(out_dtype)

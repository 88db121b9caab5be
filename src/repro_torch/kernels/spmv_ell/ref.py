"""Plain PyTorch version of the SpMV benchmark (SHOC; paper §4.2), ELLPACK
format.

``y[i] = Σ_j data[i, j] * x[cols[i, j]]`` with per-row padded nonzeros.
The paper notes SpMV's unstructured reads cannot be expressed precisely by
Lightning annotations: the access region is *overestimated* as the whole
vector (``read x[:]``), which is the GATHER pattern in the planner.

Columns follow what the reference's kernel computes, ``jnp.take(x, cols,
fill_value=0)``: a column c in [-n, 0) reads ``x[c + n]``, one in [0, n)
reads ``x[c]``, and any other reads 0.  (The reference's own plain version,
``x[cols]``, clamps c >= n to ``x[n - 1]`` instead; its public ``spmv_ell``
is the kernel, so the port follows the kernel.)
"""

from __future__ import annotations

import torch


def spmv_ell_ref(
    data: torch.Tensor,  # (rows, max_nnz) f32
    cols: torch.Tensor,  # (rows, max_nnz) int32
    x: torch.Tensor,  # (n,)
    pad_mask: torch.Tensor | None = None,  # (rows, max_nnz) 1.0 valid / 0.0 pad
) -> torch.Tensor:
    n = x.shape[0]
    idx = cols.long()
    idx = torch.where(idx < 0, idx + n, idx)  # [-n, 0) wraps
    if n == 0:
        gathered = torch.zeros(cols.shape, dtype=x.dtype, device=x.device)
    else:
        valid = (idx >= 0) & (idx < n)
        gathered = torch.where(valid, x[idx.clamp_(0, n - 1)], 0.0)
    terms = data * gathered  # (rows, max_nnz)
    if pad_mask is not None:
        terms = terms * pad_mask
    return terms.sum(dim=1)

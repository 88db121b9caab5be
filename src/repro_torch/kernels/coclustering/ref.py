"""Plain PyTorch version of the CGC co-clustering application (paper §4.6).

Bregman block-average co-clustering of a matrix Z (space × time): rows and
columns each have a cluster assignment; every iteration recomputes the
co-cluster means and reassigns rows (then columns) to the cluster minimizing
I-divergence.  The three reductions per iteration — along rows, along
columns, and over all entries — are the communication-intensive part the
paper highlights.

This follows CGC's numpy implementation shape-for-shape so the Lightning
version can be validated iteration-by-iteration.
"""

from __future__ import annotations

import torch

EPS = 1e-8


def one_hot(assign: torch.Tensor, num: int,
            dtype: torch.dtype) -> torch.Tensor:
    """(len, num) one-hot rows; an index outside ``[0, num)`` gives a row
    of zeros."""
    index = torch.arange(num, device=assign.device)
    return (assign.long()[:, None] == index).to(dtype)


def cluster_sums_ref(
    z: torch.Tensor,  # (n, m)
    row_assign: torch.Tensor,  # (n,) integers in [R]
    col_assign: torch.Tensor,  # (m,) integers in [C]
    nrow_clusters: int,
    ncol_clusters: int,
) -> torch.Tensor:
    """Co-cluster sums CoCavg[R, C] = Σ_{i∈r, j∈c} Z[i, j]."""
    r1 = one_hot(row_assign, nrow_clusters, z.dtype)  # (n, R)
    c1 = one_hot(col_assign, ncol_clusters, z.dtype)  # (m, C)
    return r1.T @ z @ c1


def coclustering_iteration_ref(
    z: torch.Tensor,
    row_assign: torch.Tensor,
    col_assign: torch.Tensor,
    nrow_clusters: int,
    ncol_clusters: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One CGC iteration: returns (new_row_assign, new_col_assign)."""
    r1 = one_hot(row_assign, nrow_clusters, z.dtype)
    c1 = one_hot(col_assign, ncol_clusters, z.dtype)
    row_cnt = r1.sum(dim=0)  # (R,)
    col_cnt = c1.sum(dim=0)  # (C,)
    cc_sum = r1.T @ z @ c1  # (R, C) – the "reduce along all entries" chain
    sizes = row_cnt[:, None] * col_cnt[None, :] + EPS
    cc_avg = cc_sum / sizes + EPS

    # Row update: distance of every row to every row-cluster under the
    # current column clustering (I-divergence linearized, as in CGC).
    z_colc = z @ c1  # (n, C) — "reduction along columns"
    log_cc = torch.log(cc_avg)  # (R, C)
    d_row = col_cnt[None, None, :] * cc_avg[None, :, :] - (
        z_colc[:, None, :] * log_cc[None, :, :]
    )
    row_dist = d_row.sum(dim=2)  # (n, R)
    new_rows = torch.argmin(row_dist, dim=1).to(row_assign.dtype)

    # Column update with the *new* row assignment (CGC alternates).
    r1n = one_hot(new_rows, nrow_clusters, z.dtype)
    row_cnt_n = r1n.sum(dim=0)
    cc_sum_n = r1n.T @ z @ c1
    sizes_n = row_cnt_n[:, None] * col_cnt[None, :] + EPS
    cc_avg_n = cc_sum_n / sizes_n + EPS
    z_rowc = z.T @ r1n  # (m, R) — "reduction along rows"
    log_cc_n = torch.log(cc_avg_n)
    d_col = row_cnt_n[None, None, :] * cc_avg_n.T[None, :, :] - (
        z_rowc[:, None, :] * log_cc_n.T[None, :, :]
    )
    col_dist = d_col.sum(dim=2)  # (m, C)
    new_cols = torch.argmin(col_dist, dim=1).to(col_assign.dtype)
    return new_rows, new_cols

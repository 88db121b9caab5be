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

``spmv_ell_binned_ref`` is route ``"bin"``'s plain version: the same sum
with the entries binned into tiles first, and the zero entries skipped
where x is finite.
"""

from __future__ import annotations

import torch

#: route ``"bin"``'s column slice: 2^SLICE_BITS columns of x (16 MiB, in
#: L2 while its launch of the gather runs)
SLICE_BITS = 22
#: the most entries of one of route ``"bin"``'s count blocks (2^b rows,
#: ``block_row_bits``), which it stages in shared memory (``kBlockEntries``
#: in ``csrc/spmv_ell.cu``)
BLOCK_ENTRIES = 4096
#: the most column slices the kernel takes (``kMaxSlices`` in the source)
MAX_SLICES = 512


def block_row_bits(nnz: int) -> int:
    """log2 of the rows of route ``"bin"``'s count block: as many as keep
    its entries within ``BLOCK_ENTRIES`` (256 rows at 16 entries a row)."""
    return (BLOCK_ENTRIES // nnz).bit_length() - 1


def bin_layout(rows: int, nnz: int, n: int,
               slice_bits: int = SLICE_BITS) -> dict:
    """Route ``"bin"``'s tiles for ``rows`` x ``nnz`` entries and an x of
    n columns: the column slices, the rows of a count block (log2), the
    count blocks, and the segments (one count block's run of one slice),
    laid out by (count block, slice)."""
    slices = -(-n // (1 << slice_bits))
    bits = block_row_bits(nnz)
    count_blocks = -(-rows // (1 << bits))
    return {"slices": slices, "block_row_bits": bits,
            "count_blocks": count_blocks, "segments": count_blocks * slices}

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


def bin_entries(
    data: torch.Tensor,  # (rows, max_nnz) f32
    cols: torch.Tensor,  # (rows, max_nnz) int32
    x: torch.Tensor,  # (n,), n >= 1
    *,
    slice_bits: int = SLICE_BITS,
    block_row_bits: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Route ``"bin"``'s binning (``csrc/spmv_ell.cu``'s passes 0 and 1) in
    plain PyTorch: ``(offsets, packed, values)``, the segments' offsets
    (one more than the segments of ``bin_layout``, a segment being one
    count block's run of one slice, by count block then slice) and each
    kept entry's packed word (its row in its count block << slice_bits |
    its column in its slice, as int64) and value, row-major within a
    segment (the kernel's order within one is its atomics').  The kernel
    writes each count block's runs to a region of its own; here they are
    back to back.  ``block_row_bits`` None takes the kernel's
    (``block_row_bits(max_nnz)``).

    Kept: every entry with a column in range where x holds a NaN or an inf,
    else only those with data != 0 (d * x for d == 0 and a finite x is +-0,
    which leaves a sum from +0 as it was); an entry with its column out of
    range reads 0, so its term d * 0 is kept, as NaN against column 0, only
    where d is not finite."""
    rows, nnz = data.shape
    n = x.shape[0]
    if n < 1:
        raise ValueError("route bin gathers from an x of at least one column")
    lay = bin_layout(rows, nnz, n, slice_bits)
    bits = lay["block_row_bits"] if block_row_bits is None else block_row_bits
    slices = lay["slices"]
    count_blocks = -(-rows // (1 << bits))
    every = not bool(torch.isfinite(x).all())
    idx = cols.long()
    idx = torch.where(idx < 0, idx + n, idx)
    valid = (idx >= 0) & (idx < n)
    keep = (valid & ((data != 0) | every)) | (~valid & ~torch.isfinite(data))
    col = torch.where(valid, idx, 0)
    value = torch.where(valid, data, data * 0.0)
    row = torch.arange(rows, device=data.device)[:, None].expand(rows, nnz)
    block = row >> bits
    seg = block * slices + (col >> slice_bits)
    packed = (((row - (block << bits)) << slice_bits)
              | (col & ((1 << slice_bits) - 1)))
    seg, packed, value = seg[keep], packed[keep], value[keep]
    order = torch.argsort(seg, stable=True)
    counts = torch.bincount(seg, minlength=count_blocks * slices)
    offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    return offsets, packed[order], value[order]


def gather_bins(
    offsets: torch.Tensor,
    packed: torch.Tensor,
    values: torch.Tensor,
    x: torch.Tensor,
    rows: int,
    *,
    slices: int,
    slice_bits: int = SLICE_BITS,
    block_row_bits: int,
) -> torch.Tensor:
    """Route ``"bin"``'s gather in plain PyTorch: y from the bins of
    ``bin_entries`` (``slices`` slices of 2^slice_bits columns, count
    blocks of 2^block_row_bits rows), each segment's entries decoded from
    its index and packed word and added into y slice by slice, as the
    kernel's launches go (the kernel adds a row's entries of a slice by
    atomics, in no fixed order)."""
    seg = torch.repeat_interleave(
        torch.arange(offsets.numel() - 1, device=x.device),
        offsets[1:] - offsets[:-1])
    row = ((seg // slices) << block_row_bits) + (packed >> slice_bits)
    col = ((seg % slices) << slice_bits) + (packed & ((1 << slice_bits) - 1))
    order = torch.argsort(seg % slices, stable=True)  # slice by slice
    y = torch.zeros((rows,), dtype=x.dtype, device=x.device)
    return y.index_add_(0, row[order], (values * x[col])[order])


def spmv_ell_binned_ref(
    data: torch.Tensor,  # (rows, max_nnz) f32
    cols: torch.Tensor,  # (rows, max_nnz) int32
    x: torch.Tensor,  # (n,), n >= 1
    *,
    slice_bits: int = SLICE_BITS,
    block_row_bits: int | None = None,
) -> torch.Tensor:
    """Route ``"bin"`` in plain PyTorch: ``bin_entries``, then
    ``gather_bins``."""
    rows, nnz = data.shape
    lay = bin_layout(rows, nnz, x.shape[0], slice_bits)
    bits = lay["block_row_bits"] if block_row_bits is None else block_row_bits
    return gather_bins(
        *bin_entries(data, cols, x, slice_bits=slice_bits,
                     block_row_bits=bits),
        x, rows, slices=lay["slices"], slice_bits=slice_bits,
        block_row_bits=bits)

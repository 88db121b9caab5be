"""Chunk streaming: process arrays larger than device memory (paper §3.4).

Lightning spills chunks to host memory and overlaps the PCIe transfers with
kernel execution.  Here the big array stays in *host* memory (numpy) and
fixed-size chunks stream through the GPU with double buffering: two pinned
host staging buffers, two device chunk buffers, a copy stream beside the
compute stream and events both ways.  While chunk *i* computes, chunk *i+1*
is already being staged and copied, so transfer and compute overlap like
the paper's memory-manager pipeline.

``stream_map_reduce`` is the executable form of the paper's K-Means /
Black-Scholes streaming experiments: a per-chunk kernel plus a running
reduction, with a device working set of two chunks plus the accumulator
regardless of the total data size.
"""

from __future__ import annotations

from typing import Callable, Iterable

import numpy as np
import torch

from repro_torch.device import resolve_device


def iter_chunks(array: np.ndarray, chunk_rows: int) -> Iterable[np.ndarray]:
    for start in range(0, array.shape[0], chunk_rows):
        yield array[start : start + chunk_rows]


def stream_map_reduce(
    data: np.ndarray,  # host-resident (the "spilled" tier)
    kernel: Callable[[torch.Tensor], torch.Tensor],  # per-chunk device kernel
    combine: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    init: torch.Tensor,
    *,
    chunk_rows: int,
    pad_value=0,
    device: torch.device | str | None = None,
    stats: dict | None = None,
) -> torch.Tensor:
    """Fold ``combine(acc, kernel(chunk))`` over host-resident chunks with
    double buffering.  Device working set: two chunks + the accumulator.

    ``kernel`` and ``combine`` take and return tensors on ``device`` (the
    GPU when ``None``).  ``kernel`` must not keep or write its argument: it
    is a view of a buffer that is refilled two chunks later.

    The final (ragged) chunk is padded to ``chunk_rows`` with ``pad_value``,
    afresh every time, because the reused buffers still hold an earlier
    chunk's rows; kernels must then be padding-safe.  With
    ``pad_value=None`` nothing is padded and the kernel is handed a view of
    the valid rows only.

    If ``stats`` is a dict, it receives ``chunks``, ``bytes`` and, on a GPU,
    ``intervals_ms``: per chunk the start and end of its copy and of its
    kernel-and-combine on the device's clock, ``(copy_start, copy_end,
    compute_start, compute_end)`` in milliseconds from the first copy.
    """
    dev = resolve_device(device)
    acc = init.to(dev)
    tail = tuple(data.shape[1:])
    n_chunks = 0

    if dev.type != "cuda":
        # No copy engine to overlap with: a plain loop over the chunks.
        for chunk in iter_chunks(data, chunk_rows):
            n = chunk.shape[0]
            if pad_value is not None and n < chunk_rows:
                pad = np.full((chunk_rows - n,) + tail, pad_value, chunk.dtype)
                chunk = np.concatenate([chunk, pad])
            chunk = torch.from_numpy(np.ascontiguousarray(chunk)).to(dev)
            acc = combine(acc, kernel(chunk))
            n_chunks += 1
        if stats is not None:
            stats.update(chunks=n_chunks, bytes=int(data.nbytes))
        return acc

    dtype = torch.from_numpy(data[:0]).dtype
    staging = [torch.empty((chunk_rows,) + tail, dtype=dtype, pin_memory=True)
               for _ in range(2)]
    staging_np = [s.numpy() for s in staging]
    on_device = [torch.empty((chunk_rows,) + tail, dtype=dtype, device=dev)
                 for _ in range(2)]
    timed = stats is not None
    compute = torch.cuda.current_stream(dev)
    copier = torch.cuda.Stream(dev)
    copied = [None, None]  # per slot: its copy to the device has ended
    consumed = [None, None]  # per slot: the kernel reading it has ended
    marks = []  # per chunk: (copy_start, copy_end, compute_start, compute_end)

    for i, chunk in enumerate(iter_chunks(data, chunk_rows)):
        slot = i % 2
        n = chunk.shape[0]
        rows = n if pad_value is None else chunk_rows
        if i >= 2:
            # The staging buffer is free once the copy out of it is done ...
            copied[slot].synchronize()
            # ... and the device buffer once the kernel reading it is done.
            copier.wait_event(consumed[slot])
        copy_start, copy_end, compute_start, compute_end = (
            torch.cuda.Event(enable_timing=timed) for _ in range(4))
        # Pageable memory would make the copy synchronous: stage it in
        # pinned memory on the host, then issue the asynchronous copy.
        np.copyto(staging_np[slot][:n], chunk)
        if n < rows:
            staging_np[slot][n:rows] = pad_value
        with torch.cuda.stream(copier):
            if timed:
                copy_start.record(copier)
            on_device[slot][:rows].copy_(staging[slot][:rows],
                                         non_blocking=True)
            copy_end.record(copier)
        compute.wait_event(copy_end)
        if timed:
            compute_start.record(compute)
        acc = combine(acc, kernel(on_device[slot][:rows]))
        compute_end.record(compute)
        copied[slot], consumed[slot] = copy_end, compute_end
        if timed:
            marks.append((copy_start, copy_end, compute_start, compute_end))
        n_chunks += 1

    if timed:
        stats.update(chunks=n_chunks, bytes=int(data.nbytes))
        if marks:
            compute.synchronize()
            origin = marks[0][0]
            stats["intervals_ms"] = [
                tuple(origin.elapsed_time(e) for e in m) for m in marks
            ]
    return acc


def stream_kmeans(
    points: np.ndarray,  # (n, f) host-resident, any size
    centroids: torch.Tensor,  # (k, f)
    *,
    chunk_rows: int = 1 << 20,
    use_pallas: bool | None = None,
    use_kernel: bool | None = None,
    device: torch.device | str | None = None,
    stats: dict | None = None,
) -> torch.Tensor:
    """One K-Means iteration over host-resident data of any size — the
    paper's flagship spilling experiment (Figs. 10–12), end to end.

    The ragged last chunk is handed over as its valid rows only (the CUDA
    kernel masks rows, and so does the plain version by construction), so
    no padded row is ever counted and nothing is subtracted afterwards.
    ``use_pallas=False`` (the reference's name) or ``use_kernel=False``
    takes the plain version on any device; both default to the kernel, and
    naming both with different values raises.

    The accumulator is f32: counts are exact only below 2**24 points per
    cluster."""
    from repro_torch.kernels.kmeans import (
        kmeans_assign_reduce,
        kmeans_assign_reduce_ref,
    )

    if (use_pallas is not None and use_kernel is not None
            and bool(use_pallas) != bool(use_kernel)):
        raise ValueError(f"use_pallas={use_pallas} and use_kernel="
                         f"{use_kernel} disagree")
    use = next((u for u in (use_kernel, use_pallas) if u is not None), True)
    dev = resolve_device(device)
    assign = kmeans_assign_reduce if use else kmeans_assign_reduce_ref
    centroids = centroids.to(dev)
    k, f = centroids.shape

    def kernel(chunk):
        sums, counts = assign(chunk, centroids)
        return torch.cat([sums, counts[:, None]], dim=1)  # (k, f+1)

    def combine(acc, part):
        return acc + part

    init = torch.zeros((k, f + 1), dtype=torch.float32, device=dev)
    agg = stream_map_reduce(
        points, kernel, combine, init, chunk_rows=chunk_rows,
        pad_value=None, device=dev, stats=stats,
    )
    sums, counts = agg[:, :f], agg[:, f]
    counts = torch.clamp(counts, min=1.0)
    return (sums / counts[:, None]).to(centroids.dtype)

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

builds the CUDA kernels from ``src/repro_torch/csrc``, holds each against
its plain PyTorch version on the card, and drives the port's paths —
annotated-kernel launches through ``Context.launch`` (the 1-D stencil,
HotSpot, K-Means, co-clustering sums, GEMM, and the paper's section 4.2
benchmarks Black-Scholes, SpMV, MD5, N-Body and the correlator) and
host-memory streaming through ``stream_kmeans``, at sizes a user of the
paper's benchmarks would call real (the launch phase's mesh pass runs five
of those applications again over 4 workers of one ``Context`` on the one
card, each held against 1 worker); then LM serving through
``ServeEngine`` at full width and depth in bf16 (random weights from
``--seed``) with one model of each family the port serves: phi3-mini-3.8b
(the flash- and decode-attention kernels), rwkv6-3b (the WKV6 kernel) and
recurrentgemma-2b (the RG-LRU kernel, and flash attention in a prefill's
local attention).  Phases (each prints one JSON line with the seconds it
took): ``env``, ``build``, ``kernels``, ``launch``, ``stream``, and
``serve`` once for each model.  GEMM, flash attention, decode attention,
the correlator, WKV6, RG-LRU, K-Means, SpMV, MD5 and N-Body have more
than one route (``"wgmma"``: the tensor cores fed by TMA; ``"mma"``: decode
attention's query heads on the tensor cores by ``mma.sync``, fed by
``cp.async``; ``"pipe"``: the f32 GEMM on the CUDA cores with its loads
one stage ahead; ``"tri"``: the correlator's tiles with i <= j, the rest
mirrored; ``"chunk"``: WKV6 and RG-LRU as scans over chunks of time;
``"private"``: K-Means with several points a thread and accumulators
private to a thread; ``"bin"``: SpMV's entries binned by column slice so
that its gathers hit L2; ``"unwind"``: MD5 with the target's last eight
rounds undone on the host; ``"tile"``: N-Body with two targets a thread
over slices of the sources and an unguarded rsqrt; ``"fma"``: the first
kernels, on the CUDA cores): the run
requires the redesigned route for the main-path calls, the tensor cores'
instructions (``HGMMA``, ``HMMA``) in those routes' kernels only, no
register spills in them, and times their first version
(``"fma"``) beside them.  Any
exception or any comparison outside its tolerance ends the run with a
non-zero exit code.  The last three
lines of the output are the kernel table, the card's name and power limit,
and the verdict.

It needs a CUDA device and fails without one.  ``--rehearse`` runs the same
control flow at toy sizes on the CPU with the plain versions, to find wrong
paths and shapes where there is no card; it measures nothing and its last
line says ``"ok": false``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import time
import traceback
import warnings

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.core import (  # noqa: E402
    BlockDist,
    BlockWork,
    Context,
    KernelDef,
    ReplicatedDist,
    RowDist,
    StencilDist,
)
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core.streaming import stream_kmeans  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    _build,
    attention_ref,
    black_scholes,
    black_scholes_ref,
    cluster_sums,
    cluster_sums_ref,
    correlate,
    correlate_ref,
    decode_attention,
    decode_attention_ref,
    flash_attention,
    gemm,
    gemm_ref,
    hotspot_step,
    hotspot_step_ref,
    kmeans_assign_reduce,
    kmeans_assign_reduce_ref,
    md5_search,
    md5_search_ref,
    md5_u32x2,
    nbody_forces,
    nbody_forces_ref,
    rg_lru,
    spmv_ell,
    spmv_ell_ref,
    wkv6,
    wkv6_ref,
)
from repro_torch.kernels.black_scholes.kernel import (  # noqa: E402
    black_scholes_cuda,
)
from repro_torch.kernels.common import (  # noqa: E402
    H100_SXM_BF16_FLOPS,
    H100_SXM_FP32_FLOPS,
    H100_SXM_HBM_BYTES_PER_S,
    H100_SXM_INT32_ALU_OPS,
    H100_SXM_INT32_OPS,
)
from repro_torch.kernels.coclustering.kernel import (  # noqa: E402
    cluster_sums_cuda,
)
from repro_torch.kernels.correlator.kernel import (  # noqa: E402
    TILE as CORR_TILE,
    correlate_cuda,
    correlate_route,
)
from repro_torch.kernels.decode_attention.kernel import (  # noqa: E402
    decode_attention_cuda,
)
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention_cuda,
)
from repro_torch.kernels.gemm.kernel import gemm_cuda  # noqa: E402
from repro_torch.kernels.kmeans.kernel import kmeans_cuda  # noqa: E402
from repro_torch.kernels.md5.kernel import (  # noqa: E402
    md5_search_cuda,
    md5_unwound_search_cuda,
)
from repro_torch.kernels.md5.ref import (  # noqa: E402
    KEY_XOR,
    UNWIND_TEST_ROUNDS,
    md5_final_state,
    md5_message,
    md5_unround,
    md5_unwind,
    md5_word1_target,
    word_index,
)
from repro_torch.kernels.nbody.kernel import (  # noqa: E402
    TILE as NBODY_TILE,
    TILE_SLICES as NBODY_TILE_SLICES,
    nbody_cuda,
)
from repro_torch.kernels.nbody.ref import (  # noqa: E402
    SOFTENING2,
    nbody_slices,
)
from repro_torch.kernels.rg_lru.kernel import (  # noqa: E402
    CHUNK_LEN as LRU_CHUNK_LEN,
    rg_lru_cuda,
    rg_lru_route,
)
from repro_torch.kernels.rg_lru.ref import (  # noqa: E402
    rg_lru_chunk_carry,
    rg_lru_chunk_local,
    rg_lru_chunk_outputs,
    rg_lru_scan,
)
from repro_torch.kernels.rwkv6.kernel import (  # noqa: E402
    CHUNK_LEN,
    wkv6_cuda,
    wkv6_route,
)
from repro_torch.kernels.rwkv6.ref import (  # noqa: E402
    wkv6_chunk_carry,
    wkv6_chunk_outputs,
    wkv6_chunk_updates,
)
from repro_torch.kernels.spmv_ell.kernel import spmv_ell_cuda  # noqa: E402
from repro_torch.kernels.spmv_ell.ref import (  # noqa: E402
    bin_entries,
    bin_layout,
    gather_bins,
)
from repro_torch.kernels.stencil2d.kernel import hotspot_cuda  # noqa: E402
from repro_torch.models import api as model_api  # noqa: E402
from repro_torch.models import attention as model_attention  # noqa: E402
from repro_torch.models import rglru as model_rglru  # noqa: E402
from repro_torch.models import rwkv as model_rwkv  # noqa: E402
from repro_torch.obs.trace import Tracer  # noqa: E402
from repro_torch.serve.engine import (  # noqa: E402
    Request,
    ServeEngine,
    _splice_state,
)

#: the wrappers whose ``launches`` counters prove the path went through the
#: hand-written kernels
WRAPPERS = {
    "kmeans": kmeans_cuda,
    "hotspot": hotspot_cuda,
    "cluster_sums": cluster_sums_cuda,
    "gemm": gemm_cuda,
    "black_scholes": black_scholes_cuda,
    "spmv_ell": spmv_ell_cuda,
    "md5": md5_search_cuda,
    "nbody": nbody_cuda,
    "flash_attention": flash_attention_cuda,
    "decode_attention": decode_attention_cuda,
    "correlate": correlate_cuda,
    "wkv6": wkv6_cuda,
    "rg_lru": rg_lru_cuda,
}


def zero_counts() -> None:
    """Every wrapper's launch count, and its counts by route, to 0."""
    for wrapper in WRAPPERS.values():
        wrapper.launches = 0
        for route in getattr(wrapper, "routes", {}):
            wrapper.routes[route] = 0


def route_counts() -> dict:
    """The launches of each two-route wrapper by route."""
    return {name: dict(w.routes) for name, w in WRAPPERS.items()
            if hasattr(w, "routes")}


@dataclasses.dataclass(frozen=True)
class Sizes:
    stencil_n: int = 1 << 24
    hotspot: tuple = (8192, 8192)
    hotspot_steps: int = 20
    kmeans_n: int = 1 << 26
    kmeans_iters: int = 5
    csums: tuple = (16384, 8192)
    gemm: int = 8192
    stream_n: int = 1 << 28
    stream_chunk_rows: int = 1 << 22
    stream_iters: int = 2
    # the paper's section 4.2 benchmarks (BS and SpMV also section 4.3)
    bs_n: int = 1 << 29  # options: 10 GiB of inputs and outputs
    spmv: tuple = (1 << 25, 16)  # rows = len(x), max_nnz
    # a shape SpMV's route "bin" takes, ragged in rows and n: rows,
    # max_nnz, n
    spmv_bin_ragged: tuple = (3 * (1 << 20) + 37, 8, (1 << 24) + 5)
    md5_n: int = 1 << 30  # keys
    nbody_n: int = 1 << 17  # bodies
    nbody_slab: int = 1024  # targets held against the float64 version
    # attention kernels: (B, HQ, HKV, S, D) and (B, HQ, HKV, T, D), the
    # serving path's (phi3-mini-3.8b: prefill of 2048 tokens; 8 slots of a
    # 2184-position cache) and gemma-2b's MQA (group 8, head_dim 256)
    flash: tuple = (1, 32, 32, 2048, 96)
    flash_gemma: tuple = (1, 8, 1, 1000, 256)
    decode: tuple = (8, 32, 32, 2184, 96)
    decode_gemma: tuple = (8, 8, 1, 2184, 256)
    # recurrentgemma-2b's ring-buffer decode: 8 slots, 10 query heads on
    # one kv head of 256, a window of 2048
    decode_rgemma: tuple = (8, 10, 1, 2048, 256)
    # the correlator: (C, T, A) channels, samples, antennas (1.61 GB f32)
    corr: tuple = (1024, 768, 256)
    # the recurrent scans at the serving path's shapes: rwkv6-3b's prefill
    # of 2048 tokens and 8-slot decode step, (B, H, T, K = V); and
    # recurrentgemma-2b's, (B, T, D)
    wkv: tuple = (1, 40, 2048, 64)
    wkv_decode: tuple = (8, 40, 1, 64)
    lru: tuple = (1, 2048, 2560)
    lru_decode: tuple = (8, 1, 2560)
    # the LM serving path
    serve_smoke: bool = False  # the full configs, not their smoke ones
    serve_requests: int = 24
    serve_requests_recurrent: int = 24  # rwkv6-3b's and recurrentgemma-2b's
    serve_slots: int = 8
    serve_prompt: tuple = (128, 2048)  # prompt lengths, heavy-tailed
    serve_new: tuple = (32, 128)  # max_new_tokens, uniform
    serve_check_len: int = 2048  # prompt of the prefill check
    serve_check_len_window: int = 2600  # the hybrid's: past its window
    profile_steps: int = 3
    reps: int = 5


FULL = Sizes()
TOY = Sizes(stencil_n=1 << 12, hotspot=(96, 160), hotspot_steps=3,
            kmeans_n=1 << 12, kmeans_iters=2, csums=(192, 320), gemm=96,
            stream_n=(1 << 13) + 100, stream_chunk_rows=1 << 11,
            stream_iters=2, bs_n=(1 << 12) + 3, spmv=((1 << 10) + 8, 16),
            spmv_bin_ragged=((1 << 12) + 37, 8, (1 << 12) + 5),
            md5_n=1 << 13, nbody_n=1000, nbody_slab=256,
            flash=(1, 4, 4, 64, 32), flash_gemma=(1, 4, 1, 40, 64),
            decode=(3, 4, 4, 70, 32), decode_gemma=(3, 4, 1, 70, 64),
            decode_rgemma=(3, 5, 1, 70, 64),
            corr=(4, 40, 70), wkv=(1, 4, 140, 16), wkv_decode=(3, 4, 1, 16),
            lru=(1, 160, 64), lru_decode=(3, 1, 64),
            serve_smoke=True, serve_requests=6, serve_requests_recurrent=6,
            serve_slots=3, serve_prompt=(4, 24), serve_new=(2, 6),
            serve_check_len=24, serve_check_len_window=24, profile_steps=1,
            reps=1)

KM_F, KM_K = 4, 40  # the paper's K-Means: 4 features, 40 clusters
CS_R, CS_C = 8, 6  # co-clustering example: 8 row and 6 column clusters
RISKFREE = 0.02  # Black-Scholes' default rate, for put-call parity
#: the MD5 target sits this far below n, so that every block of keys runs
MD5_PLANT_BELOW_N = 4099
MD5_NO_MATCH = (1, 2, 3, 4)  # a digest no key of the runs has
#: elements compared at a time, so that float64 copies stay small
CHECK_SLAB = 1 << 26


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def require(cond, *what) -> None:
    """A check that fails the run (kept under ``python -O``, unlike assert)."""
    if not cond:
        raise AssertionError(" ".join(str(w) for w in what) or "check failed")


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


#: host seconds a kernel call may take (checks, allocations, the ctypes
#: call), covered by the device sleep ahead of queued calls
KERNEL_HOST_S = 1e-3
SM_CLOCK_HZ = 1.98e9  # boost clock: the sleep counts cycles


def time_ms(fn, device: torch.device, reps: int, warmup: bool = True,
            queued: float = 0.0) -> float | None:
    """Median of ``reps`` runs after one warm-up, by CUDA events.  Every
    timed shape is larger than the L2 cache, so no flush is needed.  A
    plain version that takes seconds is timed once, without a warm-up.
    ``queued`` (host seconds a call may take): for calls shorter than their
    own host work, the ``reps`` calls are enqueued behind a device sleep
    that long, and timed back to back between two events, so that the mean
    is the device's time and not the host's."""
    if warmup or device.type != "cuda":
        fn()
        sync(device)
    if device.type != "cuda":
        return None  # a rehearsal measures nothing
    if queued:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(reps * queued * SM_CLOCK_HZ))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check_close(name: str, got: torch.Tensor, want: torch.Tensor, *,
                rtol: float, atol: float) -> tuple[float, float]:
    """``|got - want| <= atol + rtol * |want|`` everywhere, else fail.
    Returns the largest absolute and relative (over nonzero ``want``)
    differences.  Compared in float64, ``CHECK_SLAB`` elements at a time."""
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    got, want = got.reshape(-1), want.reshape(-1)
    bad, abs_err, rel_err = 0, 0.0, 0.0
    for lo in range(0, got.numel(), CHECK_SLAB):
        g = got[lo:lo + CHECK_SLAB].double()
        w = want[lo:lo + CHECK_SLAB].double()
        if not torch.isfinite(g).all():
            raise AssertionError(f"{name}: result has non-finite values")
        diff = (g - w).abs()
        bad += int((diff > atol + rtol * w.abs()).sum())
        abs_err = max(abs_err, float(diff.max()))
        nonzero = w != 0
        if nonzero.any():
            rel_err = max(rel_err,
                          float((diff[nonzero] / w[nonzero].abs()).max()))
    if bad:
        raise AssertionError(
            f"{name}: {bad} of {got.numel()} elements outside "
            f"rtol={rtol} atol={atol} (max abs {abs_err:.3e}, max rel "
            f"{rel_err:.3e})")
    return abs_err, rel_err


def bound(bytes_moved: float, operations: float,
          op_rate: float) -> tuple[float, str]:
    """Least time in ms the card could take: each input read once and each
    output written once at the memory rate, or the operations at the peak
    rate of their type, whichever is larger (H100 SXM data-sheet peaks)."""
    t_bytes = bytes_moved / H100_SXM_HBM_BYTES_PER_S * 1e3
    t_ops = operations / op_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Inputs, made on the device from a seed
# ---------------------------------------------------------------------------


def lattice_centers(gen: torch.Generator, device) -> torch.Tensor:
    """``KM_K`` cluster centres on the lattice {0, 3, 6}^4: no two closer
    than 3, so with noise bounded by 0.5 no point lies near a bisector and
    the exact-count comparison cannot flip on rounding."""
    grid = torch.cartesian_prod(*[torch.tensor([0.0, 3.0, 6.0])] * KM_F)
    pick = torch.randperm(grid.shape[0], generator=gen, device=device)[:KM_K]
    return grid.to(device)[pick].contiguous()


def clustered_points(n: int, centers: torch.Tensor,
                     gen: torch.Generator) -> torch.Tensor:
    device = centers.device
    which = torch.randint(0, centers.shape[0], (n,), generator=gen,
                          device=device)
    pts = torch.rand((n, centers.shape[1]), generator=gen, device=device)
    pts.sub_(0.5).add_(centers[which])
    return pts


def start_centroids(centers: torch.Tensor,
                    gen: torch.Generator) -> torch.Tensor:
    jitter = torch.rand(centers.shape, generator=gen, device=centers.device)
    return centers + 0.4 * (jitter - 0.5)


def kmeans_inputs(n, k, f, gen, device):
    """(points, centroids): around the lattice centres at the paper's
    (k, f) = (KM_K, KM_F); at any other (k, f) around centres 4 apart on
    the diagonal.  Either way the clusters are separated, so that the
    counts compare exactly."""
    if (k, f) == (KM_K, KM_F):
        centers = lattice_centers(gen, device)
    else:
        centers = 4.0 * torch.arange(k, device=device, dtype=torch.float32
                                     )[:, None].repeat(1, f)
    return clustered_points(n, centers, gen), start_centroids(centers, gen)


def kmeans_check(name, got, want, points):
    """Counts exactly equal (integers; separated clusters), summing to n;
    sums within rtol 1e-4 atol 1e-3 (another order of summation)."""
    if not torch.equal(got[1], want[1]):
        raise AssertionError(f"{name}: counts differ: "
                             f"{(got[1] - want[1]).abs().max()}")
    # Summed in float64: exact for integer counts, where an f32 sum of
    # exact counts of 2^26 points misses n about half the time.
    require(float(got[1].double().sum()) == float(points.shape[0]), name,
            "counts do not sum to n")
    return check_close(name, got[0], want[0], rtol=1e-4, atol=1e-3)


def hotspot_inputs(shape, gen, device):
    temp = 60.0 + 30.0 * torch.rand(shape, generator=gen, device=device)
    power = 0.25 * torch.rand(shape, generator=gen, device=device)
    return temp, power


def csums_inputs(shape, gen, device):
    n, m = shape
    z = torch.rand(shape, generator=gen, device=device)
    ra = torch.randint(0, CS_R, (n,), generator=gen, device=device,
                       dtype=torch.int32)
    ca = torch.randint(0, CS_C, (m,), generator=gen, device=device,
                       dtype=torch.int32)
    return z, ra, ca


def gemm_inputs(m, k, n, dtype, gen, device):
    # Scaled so that C is of order 1: the absolute tolerance then means the
    # same at k = 8192 as in the reference's sweep at k of a few hundred.
    scale = float(k) ** -0.25
    a = (torch.randn((m, k), generator=gen, device=device) * scale).to(dtype)
    b = (torch.randn((k, n), generator=gen, device=device) * scale).to(dtype)
    return a, b


def bs_inputs(n, gen, device):
    """Prices, strikes and years with the reference sweep's distributions
    (5 + 25|N|, 1 + 99|N|, 0.25 + 9|N|)."""
    def make(lo, scale):
        return torch.randn((n,), generator=gen, device=device).abs_() \
            .mul_(scale).add_(lo)
    return make(5.0, 25.0), make(1.0, 99.0), make(0.25, 9.0)


def spmv_inputs(rows, nnz, n, gen, device):
    """The reference sweep's ELL matrix: entries uniform in [0, 1) with
    about 70 % nonzero, columns uniform in [0, n); x uniform."""
    data = torch.rand((rows, nnz), generator=gen, device=device)
    data.mul_(torch.rand((rows, nnz), generator=gen, device=device) < 0.7)
    cols = torch.randint(0, n, (rows, nnz), generator=gen, device=device,
                         dtype=torch.int32)
    return data, cols, torch.rand((n,), generator=gen, device=device)


def spmv_ragged_inputs(nnz, gen, device):
    """(300, nnz) with columns out of range: -1 reads x[n-1], n and n + 5
    read 0 (the reference kernel's fill mode)."""
    data, cols, x = spmv_inputs(300, nnz, 300, gen, device)
    cols[::7, 0] = -1
    cols[1::7, 5] = 300
    cols[2::7, 10] = 305
    return data, cols, x


def spmv_bin_inputs(shape, gen, device, nan_under_zeros=False):
    """(rows, max_nnz, n) with columns out of range (-1 reads x[n-1]; n,
    n + 5 and -n - 3 read 0) and, with ``nan_under_zeros``, NaN in x at
    the columns of five zero entries (so y is NaN in their rows, as the
    reference's 0 * NaN gives)."""
    rows, nnz, n = shape
    data, cols, x = spmv_inputs(rows, nnz, n, gen, device)
    cols[::7, 0] = -1
    cols[1::7, 3 % nnz] = n
    cols[2::7, 5 % nnz] = n + 5
    cols[3::7, 7 % nnz] = -n - 3
    if nan_under_zeros:
        zero = (data == 0).nonzero()[:5]
        x[cols[zero[:, 0], zero[:, 1]] % n] = float("nan")
    return data, cols, x


#: SpMV against its plain version: the reference sweep's rtol and atol
#: (another order of a sum of max_nnz terms), NaN exactly where the plain
#: version has NaN
SPMV_TOL = (1e-5, 1e-6)


def spmv_limit_share(got, want) -> float:
    """``close_share`` at ``SPMV_TOL`` off the rows where ``want`` is NaN,
    and inf where the NaN rows differ."""
    nan = torch.isnan(want)
    if not torch.equal(torch.isnan(got), nan):
        return float("inf")
    return close_share(got[~nan], want[~nan], *SPMV_TOL) if (~nan).any() \
        else 0.0


def spmv_check(name, got, want, *inputs):
    """y within ``SPMV_TOL`` of the plain version, NaN in the same rows."""
    nan = torch.isnan(want)
    require(torch.equal(torch.isnan(got), nan), name, "NaN in other rows "
            "than the plain version's")
    rtol, atol = SPMV_TOL
    return check_close(name, got[~nan], want[~nan], rtol=rtol, atol=atol)


def spmv_bin_faults(shape, gen, device) -> list[dict]:
    """Route "bin" on a ragged shape with NaN in x under zero entries,
    held to the plain version (``spmv_check``), and two planted faults
    built from its plain passes that must fail that check: one tile's
    entries dropped (the middle slice of the middle count block), and the
    zero entries skipped though x holds NaN (the finite flag ignored)."""
    data, cols, x = spmv_bin_inputs(shape, gen, device, nan_under_zeros=True)
    want = spmv_ell_ref(data, cols, x)
    require(bool(torch.isnan(want).any()), "no NaN row to hold")
    got = spmv_ell(data, cols, x)
    sync(device)
    spmv_check("spmv_ell/bin faults' input", got, want)
    rows, nnz = data.shape
    lay = bin_layout(rows, nnz, x.shape[0])
    tiles = {"slices": lay["slices"], "block_row_bits": lay["block_row_bits"]}
    offsets, packed, values = bin_entries(data, cols, x)
    seg = lay["count_blocks"] // 2 * lay["slices"] + lay["slices"] // 2
    dropped = values.clone()
    dropped[int(offsets[seg]):int(offsets[seg + 1])] = 0.0
    finite = torch.nan_to_num(x, nan=0.0)
    faults = {
        "tile_dropped": gather_bins(offsets, packed, dropped, x, rows,
                                    **tiles),
        "finite_flag_ignored": gather_bins(*bin_entries(data, cols, finite),
                                           x, rows, **tiles),
    }
    return require_caught("spmv_ell", [
        {"fault": label, "limit_share": spmv_limit_share(out, want)}
        for label, out in faults.items()])


def ell_to_csr(data, cols, x):
    """The same matrix as a CSR tensor (every ELL entry kept, zeros too),
    for the library's SpMV; built outside the timed region."""
    rows, nnz = data.shape
    crow = torch.arange(0, rows * nnz + 1, nnz, dtype=torch.int32,
                        device=data.device)
    csr = torch.sparse_csr_tensor(crow, cols.reshape(-1), data.reshape(-1),
                                  size=(rows, x.shape[0]),
                                  check_invariants=False)
    return csr, x


def md5_digest(key: int) -> tuple[int, int, int, int]:
    """The digest the search looks for when the answer is ``key``."""
    w0 = torch.tensor([key & 0xFFFFFFFF], dtype=torch.int64)
    return tuple(int(v[0]) for v in md5_u32x2(w0, w0 ^ KEY_XOR))


def md5_int_ops_per_key() -> dict:
    """The fewest 32-bit integer instructions one key of the search needs,
    counted from the rounds with every constant folded, the target's last
    eight rounds undone once a search (route "unwind"): rounds 1-52 and
    the test of b after round 52, by the pipes that can run them.  A round
    is the 3-input logic function (one LOP3), ``a + f + (K + m[g])`` (one
    IADD3, as K + m[g] folds to a constant; two where m[g] is a key word)
    and ``b + rotl(sum, s)``.  Round 1 works on constants until it adds w0:
    its rotate-add and one add.  Rounds 2-4 add to a constant ``a``, so a
    key word costs them nothing more.  Then the second message word (one
    LOP3, the xor) and the test, ``b + w1 == T`` (an add and an ISETP).

    ``alu_only``: the LOP3s, the xor and the ISETP, which only the ALU pipe
    runs.  ``rotate_adds``: one a round, each one ALU instruction (LEA.HI,
    a funnel shift and add) or two on the FMA pipe (IMAD.HI and IMAD, as
    ``md5.cu``'s ``kRotateOnFma`` form writes it).  ``adds``: the rest,
    each one instruction on either pipe (IADD3, or IMAD by a 1).
    ``total``: all of them with every rotate-add as one instruction."""
    rounds = UNWIND_TEST_ROUNDS
    key_word_rounds = sum(word_index(i) in (0, 1) for i in range(4, rounds))
    total = 2 + (rounds - 1) * 3 + key_word_rounds + 1 + 2
    alu_only = (rounds - 1) + 1 + 1  # LOP3s, the xor, the ISETP
    return {"total": total, "alu_only": alu_only, "rotate_adds": rounds,
            "adds": total - alu_only - rounds}


def md5_seconds_per_key(ops: dict) -> tuple[float, float]:
    """(seconds, rotate-adds on the FMA pipe) of one key at the least time
    over where its instructions run: r of its rotate-adds as two FMA-pipe
    instructions each, the rest on the ALU pipe with the ALU-only ones, and
    the adds on either.  Each pipe runs 64 lanes an SM
    (``H100_SXM_INT32_ALU_OPS``; IMAD.HI taken at that rate too, though it
    may issue slower), the two together the issue ceiling
    (``H100_SXM_INT32_OPS``, twice that).  With the adds split to even the
    pipes, the time is the largest of the issue time, the ALU pipe's with
    no adds and the FMA pipe's with none: lines in r, least at r = 0, at
    every rotate-add moved, or where two of them cross."""
    issue, pipe = H100_SXM_INT32_OPS, H100_SXM_INT32_ALU_OPS
    alu = ops["alu_only"] + ops["rotate_adds"]

    def seconds(r: float) -> float:
        return max((ops["total"] + r) / issue, (alu - r) / pipe,
                   2 * r / pipe)

    crossings = [0.0, ops["rotate_adds"],
                 (issue * alu - pipe * ops["total"]) / (issue + pipe),
                 alu / 3]
    r = min((min(max(c, 0.0), ops["rotate_adds"]) for c in crossings),
            key=seconds)
    return seconds(r), r


def md5_work(n, *_):
    """The search's least time: its instructions, where they run best
    (``md5_seconds_per_key``), for n keys; 16 bytes of target read, one int
    written."""
    per_key, _ = md5_seconds_per_key(md5_int_ops_per_key())
    # as issue-ceiling instructions, so ``bound`` takes it at that rate
    return bound(20.0, float(n) * per_key * H100_SXM_INT32_OPS,
                 H100_SXM_INT32_OPS)


#: MD5's planted faults: where the key is planted, the unwound round given
#: a wrong message word (round 63 reads m[2] = 0x80), and the word it gets
MD5_WRONG_WORD = (62, 0)


def md5_faults(n: int, target, expect: int, device) -> list[dict]:
    """Route "unwind"'s launch handed values a fault would give: the
    target unwound with one round's message word wrong, and the test after
    round 52 made against round 53's value (b after round 53, the unwound
    a) in place of T.  Each must miss the key planted at ``expect``."""
    state = md5_unwind(target)
    wrong = md5_final_state(target)
    constant = md5_message(None, None)
    for i in range(63, 55, -1):
        word = MD5_WRONG_WORD[1] if i == MD5_WRONG_WORD[0] \
            else constant[word_index(i)]
        wrong = md5_unround(wrong, i, word)
    rows = []
    for label, st, word1 in (
            ("unwound_round_wrong_word", wrong, md5_word1_target(wrong)),
            ("test_at_round_53", state, state[0])):
        found = int(md5_unwound_search_cuda(n, st, word1, device)[0])
        require(found != expect, "planted fault md5/" + label,
                "still found the key", expect)
        rows.append({"fault": label, "found": found, "missed": True})
    return rows


def nbody_inputs(n, gen, device, softening2=SOFTENING2, zero_every=0):
    """Positions uniform in the unit cube, masses uniform in [0.5, 1.5)
    (the reference sweep's bodies), every ``zero_every``-th body of zero
    mass; and eps^2."""
    posm = torch.rand((n, 4), generator=gen, device=device)
    posm[:, 3] += 0.5
    if zero_every:
        posm[::zero_every, 3] = 0.0
    return posm, softening2


#: flops one N-Body pair needs: 3 subtractions, |d|^2 + eps^2 (3 multiply-
#: adds, 6 flops), rsqrt (1), m / dist^3 (3 multiplies), 3 multiply-adds
#: into the sum (6)
NBODY_FLOPS_PER_PAIR = 19
#: issue slots an ordered pair needs at least: 3 FADD, 3 FFMA (|d|^2, eps^2
#: folded), 3 FMUL (m r^3), 3 FFMA (the sums), 1 MUFU.RSQ; at the issue
#: ceiling, the least time of any route that evaluates each ordered pair
NBODY_ORDERED_SLOTS = 13
#: N-Body's ragged case by route "tile": a last source tile of 37 bodies,
#: every 7th body of zero mass
NBODY_RAGGED_TILE = 4133


def nbody_ordered_floor_ms(n: int) -> float:
    """``NBODY_ORDERED_SLOTS`` a pair over n^2 ordered pairs at the issue
    ceiling (``H100_SXM_INT32_OPS``: one warp instruction a clock on each
    scheduler, whatever its type)."""
    return NBODY_ORDERED_SLOTS * float(n) ** 2 / H100_SXM_INT32_OPS * 1e3


def bs_check(name, got, want, price, strike, years):
    """Both outputs against the plain version, and put-call parity
    ``call - put = S - K exp(-rT)`` in float64 (so that only the
    kernel's rounding counts)."""
    # rtol 1e-4 atol 2e-4: the reference sweep's, for erf/log/exp rounding.
    err_c = check_close(f"{name}/call", got[0], want[0], rtol=1e-4, atol=2e-4)
    err_p = check_close(f"{name}/put", got[1], want[1], rtol=1e-4, atol=2e-4)
    worst = 0.0
    for lo in range(0, price.numel(), CHECK_SLAB):
        sl = slice(lo, lo + CHECK_SLAB)
        lhs = got[0][sl].double() - got[1][sl].double()
        rhs = price[sl].double() - strike[sl].double() * torch.exp(
            -RISKFREE * years[sl].double())
        worst = max(worst, float((lhs - rhs).abs().max()))
    # atol 5e-4: the reference's parity tolerance.
    require(worst <= 5e-4, name, "put-call parity off by", worst)
    return max(err_c[0], err_p[0]), max(err_c[1], err_p[1])


def nbody_term_scale(posm, lo, hi, softening2=SOFTENING2):
    """``sum_j |term_ij|`` for targets [lo, hi), per axis, in posm's type:
    the size of the sum that an N-Body error is held against."""
    pos, mass = posm[:, :3], posm[:, 3]
    d = pos[None, :, :] - pos[lo:hi, None, :]
    dist2 = (d * d).sum(dim=-1) + softening2
    return torch.einsum("ij,ijk->ik",
                        mass[None, :] * torch.rsqrt(dist2) / dist2, d.abs())


def nbody_slab_check(name, got, plain, posm, lo, hi, softening2=SOFTENING2):
    """Accelerations of targets [lo, hi) against the plain version in
    float64, per target and axis within ``1e-4 * sum_j |term_ij|``: a sum
    of n f32 terms cannot be held to an absolute 5e-4 at n = 2**17.  The
    kernel's rows (``got``) and the f32 plain version's (``plain``) both."""
    p64 = posm.double()
    want = nbody_forces_ref(p64, softening2, rows=(lo, hi))
    scale = nbody_term_scale(p64, lo, hi, softening2)
    worst = (0.0, 0.0)
    for label, a in (("kernel", got), ("plain f32", plain)):
        err = (a.double() - want).abs()
        if not torch.isfinite(a).all() or (err > 1e-4 * scale).any():
            raise AssertionError(
                f"{name}: {label} off by {float((err / scale).max()):.3e} "
                "of sum |term| (limit 1e-4)")
        if label == "kernel":
            worst = (float(err.max()),
                     float((err / want.abs().clamp_min(1e-300)).max()))
    return worst


def nbody_check(name, got, want, posm, softening2, slab=1024):
    """Every target against float64 within ``1e-4 * sum_j |term_ij|``
    (``nbody_slab_check``, kernel and f32 plain version, ``slab`` targets
    at a time), except for eps^2 = 0: there every self term is 0 * inf, so
    the kernel must give NaN exactly where the plain version does
    (everywhere)."""
    if softening2 == 0:
        same = torch.equal(torch.isnan(got), torch.isnan(want))
        require(same, name, "NaN pattern differs from the plain version's")
        return 0.0, 0.0
    worst = (0.0, 0.0)
    for lo in range(0, posm.shape[0], slab):
        hi = min(posm.shape[0], lo + slab)
        err = nbody_slab_check(name, got[lo:hi], want[lo:hi], posm, lo, hi,
                               softening2)
        worst = tuple(map(max, worst, err))
    return worst


def nbody_faults(posm, softening2=SOFTENING2) -> dict:
    """Route "tile"'s sums with a planted fault, from the plain version's
    pieces: one slice's partial dropped, and the last ragged source tile
    skipped (the sources past the last whole tile)."""
    n = posm.shape[0]
    slices = nbody_slices(n, NBODY_TILE_SLICES, NBODY_TILE)
    parts = [nbody_forces_ref(posm, softening2, cols=c) for c in slices]
    whole = n - n % NBODY_TILE
    require(whole < n and len(slices) > 1, "no ragged tile or one slice")
    cut = [nbody_forces_ref(posm, softening2, cols=(lo, min(hi, whole)))
           for lo, hi in slices]
    return {"slice_partial_dropped": sum(parts[:1] + parts[2:]),
            "ragged_tile_skipped": sum(cut)}


def nbody_fault_rows(posm, softening2=SOFTENING2) -> list[dict]:
    """Each of ``nbody_faults`` must fail ``nbody_check``'s limit."""
    rows = []
    for label, bad in nbody_faults(posm, softening2).items():
        try:
            nbody_check(f"planted fault nbody/{label}", bad, bad, posm,
                        softening2)
        except AssertionError as e:
            rows.append({"fault": label, "caught": str(e)[:200]})
            continue
        raise AssertionError(f"planted fault nbody/{label} passed the check")
    return rows


def attn_tensors(b, hq, hkv, s, t, d, dtype, gen, device):
    """q (b, hq, s, d), k and v (b, hkv, t, d): normal with std 0.5 (the
    reference sweep's inputs), made in f32 and cast to ``dtype``."""
    def normal(*shape):
        return (0.5 * torch.randn(shape, generator=gen, device=device)) \
            .to(dtype)
    return normal(b, hq, s, d), normal(b, hkv, t, d), normal(b, hkv, t, d)


def flash_inputs(shape, dtype, gen, device, t=None, **kw):
    """(q, k, v, keyword arguments) for a (B, HQ, HKV, S, D) shape; T = S
    unless given; causal unless the keywords say otherwise."""
    b, hq, hkv, s, d = shape
    return (*attn_tensors(b, hq, hkv, s, t or s, d, dtype, gen, device),
            {"causal": True, **kw})


def decode_inputs(shape, dtype, gen, device, kv_len=None):
    """(q, k, v, kv_len) for a (B, HQ, HKV, T, D) shape; ``kv_len`` spread
    over [1, T] with both ends present, unless one length is given."""
    b, hq, hkv, t, d = shape
    q, k, v = attn_tensors(b, hq, hkv, 1, t, d, dtype, gen, device)
    if kv_len is None:
        lens = torch.randint(1, t + 1, (b,), generator=gen, device=device)
        lens[0], lens[-1] = 1, t
    else:
        lens = torch.full((b,), kv_len, device=device)
    return q[:, :, 0].contiguous(), k, v, lens.to(torch.int32)


def rate_of(dtype: torch.dtype) -> float:
    return H100_SXM_BF16_FLOPS if dtype == torch.bfloat16 \
        else H100_SXM_FP32_FLOPS


def visible_pairs(s: int, t: int, causal: bool, window: int | None,
                  q_offset: int) -> int:
    """(query, key) pairs the masks let through: the work attention needs."""
    q = q_offset + np.arange(s)
    hi = np.minimum(q, t - 1) if causal else np.full(s, t - 1)
    lo = np.maximum(q - window + 1, 0) if window else np.zeros(s, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_work(q, k, v, kw):
    """q, k, v read and o written once; 4 D flops a visible pair (Q K^T
    and P V) at the peak of the inputs' type."""
    b, hq, s, d = q.shape
    pairs = visible_pairs(s, k.shape[2], kw.get("causal", True),
                          kw.get("window"), kw.get("q_offset", 0))
    return bound((2 * q.numel() + k.numel() + v.numel()) * q.element_size(),
                 4.0 * b * hq * d * pairs, rate_of(q.dtype))


def decode_work(q, k, v, kv_len):
    """K and V up to kv_len, q and out, and the f32 lse, once each; 4 D
    flops a (key, query head)."""
    b, hq, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    keys = float(kv_len.clamp(max=t).sum())
    return bound(2 * hkv * d * keys * k.element_size()
                 + 2 * q.numel() * q.element_size() + 4 * b * hq,
                 4.0 * hq * d * keys, rate_of(q.dtype))


#: Attention tolerances against the plain version in the inputs' type: the
#: reference sweep's (tests/test_kernels.py): f32 2e-4 on the output (order
#: of summation) and 1e-4 on the lse; bf16 3e-2 (8 bits of mantissa; the
#: plain version also rounds its logits and probabilities to bf16 where the
#: kernels keep f32), lse alike.
ATTN_TOL = {torch.float32: (2e-4, 1e-4), torch.bfloat16: (3e-2, 3e-2)}
#: GEMM against its plain version: f32 1e-4 (true f32 products, another
#: order of summation); bf16 2e-2 (the result is rounded to bf16); a bf16
#: result is also held to the bf16 limit below.
GEMM_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
#: bf16's unit roundoff (8 significant bits)
BF16_U = 2.0 ** -8
#: A bf16 kernel is also held against the f32 plain version of the same
#: (bf16-valued) inputs, element by element, within
#: ``BF16_U * (2 |want| + 8 rms)``, ``rms`` over the row's head_dim.  The
#: kernels compute in f32 and round twice: the output to bf16 (at most
#: ``u |want|``; the second ``u`` covers the two f32 orders of summation),
#: and p to bf16 before P.V, as the reference kernel does, which adds a sum
#: of independent errors of standard deviation about ``u / sqrt(3)`` of the
#: row's rms: ``8 u rms`` is 14 of them.  The 3e-2 above is larger than a
#: typical output (about 0.5 / sqrt(keys) for these inputs), so only this
#: limit sees a dropped tile; ``planted_faults`` shows that it does.
BF16_OUT_ABS, BF16_OUT_RMS = 2.0, 8.0
#: the kernels' lse is f32 from unrounded p: the f32 limit, absolute
BF16_LSE_ATOL = 1e-4


def as_f32(inputs):
    """The inputs with every floating tensor widened to f32 (exactly)."""
    return tuple(x.float() if torch.is_tensor(x) and x.is_floating_point()
                 else x for x in inputs)


def bf16_gap(got: torch.Tensor, want: torch.Tensor) -> dict:
    """A bf16 attention output against the f32 plain version: the largest
    share of its element's limit that a difference takes (above 1 fails),
    the share of elements outside their limit, and the largest difference."""
    g, w = got.double(), want.double()
    rms = w.square().mean(-1, keepdim=True).sqrt()
    limit = BF16_U * (BF16_OUT_ABS * w.abs() + BF16_OUT_RMS * rms)
    diff = (g - w).abs()
    share = torch.where(diff == 0, torch.zeros_like(diff), diff / limit)
    share = torch.where(torch.isfinite(g), share,
                        torch.full_like(share, float("inf")))
    return {"limit_share": float(share.max()),
            "outside": float((share > 1).double().mean()),
            "max_abs_err": float(torch.nan_to_num(diff).max())}


def bf16_lse_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest lse difference over ``BF16_LSE_ATOL``."""
    return float(torch.nan_to_num((got.double() - want.double()).abs(),
                                  nan=float("inf")).max()) / BF16_LSE_ATOL


def bf16_check(name: str, out: torch.Tensor, want: torch.Tensor,
               lse=None, want_lse=None) -> dict:
    """The limit holds a kernel's result; a rehearsal's result on the CPU is
    the bf16 plain version, which rounds its logits to bf16 (its lse is off
    by about 1e-3), so there the gap is reported and not required."""
    gap = bf16_gap(out, want)
    if lse is not None:
        gap["lse_limit_share"] = bf16_lse_gap(lse, want_lse)
    worst = max(gap["limit_share"], gap.get("lse_limit_share", 0.0))
    require(worst <= 1.0 or not out.is_cuda, f"{name}: bf16 output outside "
            f"BF16_U * "
            f"({BF16_OUT_ABS} |want| + {BF16_OUT_RMS} rms) of the f32 plain "
            "version (lse 1e-4):", gap)
    return gap


def flash_check(name, got, want, *inputs):
    """Against the plain version in the inputs' type; in bf16 also against
    the f32 plain version (whose errors the row reports)."""
    tol = ATTN_TOL[got.dtype][0]
    err = check_close(name, got, want, rtol=tol, atol=tol)
    if got.dtype != torch.bfloat16:
        return err
    q, k, v, kw = as_f32(inputs)
    want32 = attention_ref(q, k, v, **kw)
    gap = bf16_check(name, got, want32)
    return gap["max_abs_err"], err[1], {
        "bf16_limit_share": gap["limit_share"],
        "bf16_plain_max_abs_err": err[0]}


def decode_check(name, got, want, *inputs):
    tol, lse_tol = ATTN_TOL[got[0].dtype]
    err = check_close(f"{name}/out", got[0], want[0], rtol=tol, atol=tol)
    check_close(f"{name}/lse", got[1], want[1], rtol=lse_tol, atol=lse_tol)
    if got[0].dtype != torch.bfloat16:
        return err
    q, k, v, n = as_f32(inputs)
    want32 = decode_attention_ref(q, k, v, kv_len=n, with_lse=True)
    gap = bf16_check(name, got[0], want32[0], got[1], want32[1])
    return gap["max_abs_err"], err[1], {
        "bf16_limit_share": gap["limit_share"],
        "bf16_lse_limit_share": gap["lse_limit_share"],
        "bf16_plain_max_abs_err": err[0]}


def masked_attention(q, k, v, keep):
    """f32 attention of q (B, HQ, S, D) on k, v (B, HKV, T, D) over the keys
    ``keep`` (broadcast to (B, HQ, S, T)) lets through; a row with none
    gives zeros, as the kernels do.  Returns (out, lse)."""
    group = q.shape[1] // k.shape[1]
    kk = k.float().repeat_interleave(group, 1)
    vv = v.float().repeat_interleave(group, 1)
    logits = torch.einsum("bhsd,bhtd->bhst", q.float(), kk) \
        / q.shape[-1] ** 0.5
    logits = logits.masked_fill(~keep, float("-inf"))
    m = logits.amax(-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(logits - m)
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bhst,bhtd->bhsd", p, vv) / l.clamp_min(1e-30)
    return out, (m + torch.log(l)).squeeze(-1)


def planted_faults(kind: str, inputs, want32) -> list[dict]:
    """Outputs of wrong kernels, made by the f32 plain computation with keys
    left out and rounded to bf16 like a kernel's output, held to the bf16
    limit: each must fail it, or the limit could not tell a wrong kernel
    from a right one.  Flash: one tile of keys past the middle dropped for
    the rows past it; the diagonal tile dropped for the second half of the
    rows; the output zeroed past a quarter of the rows.  Decode: one tile in
    the middle of each row's keys; each row's last, partial tile; the first
    quarter of the cache (one split's worth)."""
    if kind == "flash":
        q, k, v, kw = inputs
        require(kw.get("causal", True) and not kw.get("window")
                and not kw.get("q_offset"), "planted faults: plain causal")
        s, t = q.shape[2], k.shape[2]
        tile = min(64, t // 4)
        qpos = torch.arange(s, device=q.device)[:, None]
        kpos = torch.arange(t, device=q.device)[None, :]
        causal = kpos <= qpos
        t0 = (t // 2) // tile * tile
        diag = (kpos // tile == qpos // tile) & (qpos >= s // 2)
        zeroed = want32.clone()
        zeroed[:, :, s // 4:] = 0
        faults = {
            "kv_tile_dropped": masked_attention(
                q, k, v, causal & ~((kpos >= t0) & (kpos < t0 + tile)
                                    & (qpos >= t0 + tile)))[0],
            "diagonal_tile_dropped": masked_attention(
                q, k, v, causal & ~diag)[0],
            "rows_zeroed": zeroed,
        }
        want_lse = None
    else:
        q, k, v, n = inputs
        t = k.shape[2]
        tile = min(64, t // 4)
        kpos = torch.arange(t, device=q.device)[None, :]
        n = n.long()[:, None]
        valid = kpos < n
        mid = (n // 2) // tile * tile
        last = (n - 1) // tile * tile
        want_lse = want32[1]
        want32 = want32[0]
        faults = {}
        for label, drop in (
                ("mid_tile_dropped", (kpos >= mid) & (kpos < mid + tile)
                 & (n > 2 * tile)),
                ("last_tile_dropped", (kpos >= last) & (n > tile)),
                ("split_dropped", (kpos < t // 4) & (n > t // 4))):
            keep = (valid & ~drop)[:, None, None, :]
            out, lse = masked_attention(q[:, :, None], k, v, keep)
            faults[label] = (out[:, :, 0], lse[:, :, 0])
    rows = []
    for label, fault in faults.items():
        out, lse = fault if isinstance(fault, tuple) else (fault, None)
        gap = bf16_gap(out.to(torch.bfloat16), want32)
        if lse is not None:
            gap["lse_limit_share"] = bf16_lse_gap(lse, want_lse)
        caught = gap["limit_share"] > 1 or gap.get("lse_limit_share", 0) > 1
        require(caught, f"planted fault {label} passes the bf16 limit:", gap)
        rows.append({"fault": label, **gap})
    return rows


def flash_main_check(name, got, want, *inputs):
    abs_err, rel_err, extra = flash_check(name, got, want, *inputs)
    q, k, v, kw = as_f32(inputs)
    extra["planted_faults"] = planted_faults(
        "flash", inputs, attention_ref(q, k, v, **kw))
    return abs_err, rel_err, extra


def decode_main_check(name, got, want, *inputs):
    abs_err, rel_err, extra = decode_check(name, got, want, *inputs)
    q, k, v, n = as_f32(inputs)
    extra["planted_faults"] = planted_faults(
        "decode", inputs,
        decode_attention_ref(q, k, v, kv_len=n, with_lse=True))
    return abs_err, rel_err, extra


def gemm_check(name, got, want, a, b):
    """Against the plain version in the inputs' type (f32 1e-4: the order
    of summation; bf16 2e-2: the result's own rounding); in f32 also
    against a float64 product within the reference sweep's 1e-4
    (``tests/test_kernels.py``), the plain version's error (cuBLAS in true
    f32) reported beside it; in bf16 also against the f32 product of the
    same inputs within the bf16 limit (``bf16_check``, rms over a row of
    C)."""
    tol = GEMM_TOL[got.dtype]
    err = check_close(name, got, want, rtol=tol, atol=tol)
    if got.dtype == torch.float32:
        want64 = a.double() @ b.double()
        err64 = check_close(f"{name}/float64", got, want64, rtol=tol,
                            atol=tol)
        plain64 = float((want.double() - want64).abs().max())
        return err[0], err[1], {"f64_max_abs_err": err64[0],
                                "f64_max_rel_err": err64[1],
                                "plain_f64_max_abs_err": plain64}
    if got.dtype != torch.bfloat16:
        return err
    gap = bf16_check(name, got, gemm_ref(a, b, out_dtype=torch.float32))
    return gap["max_abs_err"], err[1], {
        "bf16_limit_share": gap["limit_share"],
        "bf16_plain_max_abs_err": err[0]}


def gemm_faults(a, b) -> list[dict]:
    """A product with one 64-deep K stage dropped (the one past the middle
    of K, as a ring slot the consumers skipped would drop it), rounded to
    bf16 like the kernel's output: it must fail the bf16 limit."""
    k = a.shape[1]
    k0 = (k // 2) // 64 * 64
    kk = slice(k0, min(k0 + 64, k))
    want32 = gemm_ref(a, b, out_dtype=torch.float32)
    dropped = want32 - gemm_ref(a[:, kk].contiguous(), b[kk].contiguous(),
                                out_dtype=torch.float32)
    gap = bf16_gap(dropped.to(torch.bfloat16), want32)
    require(gap["limit_share"] > 1, "planted fault k_stage_dropped passes "
            "the bf16 limit:", gap)
    return [{"fault": "k_stage_dropped", "k": [k0, kk.stop], **gap}]


def gemm_main_check(name, got, want, a, b):
    abs_err, rel_err, *extra = gemm_check(name, got, want, a, b)
    if got.dtype != torch.bfloat16:
        return abs_err, rel_err, *extra
    extra[0]["planted_faults"] = gemm_faults(a, b)
    return abs_err, rel_err, extra[0]


def sdpa_decode_setup(q, k, v, kv_len):
    """The library call's arguments: q as one query row, kv_len as a mask
    (built outside the timed region)."""
    mask = torch.arange(k.shape[2], device=q.device)[None, :] \
        < kv_len[:, None]
    return q[:, :, None], k, v, mask[:, None, None, :]


def close_share(got: torch.Tensor, want: torch.Tensor, rtol: float,
                atol: float) -> float:
    """The largest ``|got - want| / (atol + rtol |want|)`` (above 1 is
    outside the tolerance), in float64, ``CHECK_SLAB`` elements at a
    time."""
    got, want = got.reshape(-1), want.reshape(-1)
    worst = 0.0
    for lo in range(0, got.numel(), CHECK_SLAB):
        g = got[lo:lo + CHECK_SLAB].double()
        w = want[lo:lo + CHECK_SLAB].double()
        share = (g - w).abs() / (atol + rtol * w.abs())
        worst = max(worst, float(torch.nan_to_num(share, nan=float("inf"))
                                 .max()))
    return worst


def require_caught(kind: str, rows: list[dict]) -> list[dict]:
    """Each planted fault must use more than its whole limit."""
    for row in rows:
        require(row["limit_share"] > 1, f"planted fault {kind}/{row['fault']}"
                " passes the limit:", row)
    return rows


#: The correlator against its plain version: the reference sweep's rtol and
#: atol (f32 sums of 4 T products in another order).
CORR_TOL = 1e-4


def corr_inputs(c, t, a, gen, device, dtype=torch.float32):
    """Samples (C, T, A, 2) in ``dtype``: re and im normal with std 0.5
    (the reference sweep's)."""
    return ((0.5 * torch.randn((c, t, a, 2), generator=gen, device=device)
             ).to(dtype),)


def mirrored_tiles(a: int, device) -> torch.Tensor:
    """(A, A) mask of the pairs (i, j) whose 64-antenna tile row lies past
    its tile column: the tiles route "tri" writes as conjugate transposes."""
    tile = torch.arange(a, device=device) // CORR_TILE
    return tile[:, None] > tile[None, :]


def corr_mirror_misses(got: torch.Tensor) -> int:
    """Pairs of the mirrored tiles that are not bit-exactly conj(V[j, i])."""
    lower = mirrored_tiles(got.shape[1], got.device)
    conj_t = torch.stack([got[..., 0].transpose(1, 2),
                          -got[..., 1].transpose(1, 2)], dim=-1)
    return int((got != conj_t)[:, lower].sum())


def corr_check(name, got, want, samples):
    """Against the plain version, and Hermitian: V[i,j] = conj(V[j,i]).
    bf16 visibilities (summed in f32, rounded once) against the f32 plain
    version of the same samples within the bf16 limit, the rms over a row
    of V.  A result of route "tri" is also Hermitian bit for bit off the
    diagonal tiles."""
    if got.is_cuda and correlate_route(samples) == "tri":
        misses = corr_mirror_misses(got)
        require(misses == 0, name, misses, "mirrored pairs are not the "
                "conjugates of their transposes")
    if got.dtype == torch.bfloat16:
        c, a = got.shape[:2]
        want32 = correlate_ref(samples.float())
        gap = bf16_check(name, got.reshape(c, a, 2 * a),
                         want32.reshape(c, a, 2 * a))
        return gap["max_abs_err"], 0.0
    err = check_close(name, got, want, rtol=CORR_TOL, atol=CORR_TOL)
    check_close(f"{name}/hermitian re", got[..., 0],
                got[..., 0].transpose(1, 2), rtol=CORR_TOL, atol=CORR_TOL)
    check_close(f"{name}/hermitian im", got[..., 1],
                -got[..., 1].transpose(1, 2), rtol=CORR_TOL, atol=CORR_TOL)
    return err


def corr_main_check(name, got, want, samples):
    """``corr_check``, then planted faults that must fail its tolerance: one
    time tile (16 samples, the kernel's stage) dropped; the imaginary
    part's sign flipped (V^T in place of V); route "tri"'s mirrored tiles
    left at zero, and mirrored without the conjugation."""
    abs_err, rel_err = corr_check(name, got, want, samples)
    t = samples.shape[1]
    t0 = (t // 2) // 16 * 16
    dropped = samples.clone()
    dropped[:, t0:t0 + 16] = 0
    lower = mirrored_tiles(samples.shape[2], samples.device)
    require(bool(lower.any()), name, "has no mirrored tiles")
    unmirrored = want.clone()
    unmirrored[:, lower] = 0
    unconjugated = want.clone()
    unconjugated[:, lower, 1] = -unconjugated[:, lower, 1]
    faults = {"time_tile_dropped": correlate_ref(dropped),
              "im_sign_flipped": torch.stack([want[..., 0], -want[..., 1]],
                                             dim=-1),
              "mirror_left_zero": unmirrored,
              "mirror_not_conjugated": unconjugated}
    del dropped, unmirrored, unconjugated
    rows = [{"fault": label, "limit_share": close_share(out, want, CORR_TOL,
                                                        CORR_TOL)}
            for label, out in faults.items()]
    return abs_err, rel_err, {"planted_faults": require_caught("correlate",
                                                               rows)}


def corr_setup(samples):
    """The library call's argument: the samples as complex (C, T, A)."""
    return (torch.view_as_complex(samples),)


def corr_work(samples):
    """Samples read and visibilities written once; 8 flops a pair and
    sample (four real multiply-adds) over the pairs i <= j only, A (A + 1)
    / 2 of them: V is Hermitian, so the other half is a copy with the
    imaginary part negated.  At the f32 peak."""
    c, t, a, _ = samples.shape
    return bound((samples.numel() + 2 * c * a * a) * samples.element_size(),
                 8.0 * a * (a + 1) / 2 * t * c, H100_SXM_FP32_FLOPS)


#: The scans in f32 against their plain versions: the reference sweeps'
#: rtol and atol (another order of rounding over T steps).
SCAN_TOL = 1e-4


def wkv_inputs(b, h, t, dk, dv, dtype, gen, device):
    """(r, k, v, w, u, s0): r, k, v normal with std 0.5; decays
    exp(-exp(N(0, 1))), spread over (0, 1); bonus u normal with std 0.5 (the
    size of a trained model's, not the init's 0.02); a random initial state.
    r, k, v, w in ``dtype``; u and s0 f32."""
    def normal(*shape, std=0.5):
        return std * torch.randn(shape, generator=gen, device=device)
    r, k, v = normal(b, h, t, dk), normal(b, h, t, dk), normal(b, h, t, dv)
    w = torch.exp(-torch.exp(normal(b, h, t, dk, std=1.0)))
    return (r.to(dtype), k.to(dtype), v.to(dtype), w.to(dtype), normal(h, dk),
            normal(b, h, dk, dv))


def wkv_exact_decays(inputs):
    """``inputs`` with decays of exactly 0 at every 37th step (a reset) and
    exactly 1 at every 41st (no decay)."""
    r, k, v, w, u, s0 = inputs
    w = w.clone()
    w[:, :, ::37] = 0.0
    w[:, :, 5::41] = 1.0
    return r, k, v, w, u, s0


def lru_inputs(b, t, d, dtype, gen, device, sweep=False):
    """(log_a, gx, h0): log_a = -exp(U(-7, 1)), decays from 0.07 (a chain
    that forgets at once) to 0.999 (one that keeps a value for thousands of
    steps); gx and h0 normal.  ``sweep``: the reference sweep's
    -|N(0, 0.1)|.  log_a and gx in ``dtype``; h0 f32."""
    if sweep:
        la = -(0.1 * torch.randn((b, t, d), generator=gen, device=device)
               ).abs()
    else:
        la = -torch.exp(8.0 * torch.rand((b, t, d), generator=gen,
                                         device=device) - 7.0)
    gx = torch.randn((b, t, d), generator=gen, device=device)
    return (la.to(dtype), gx.to(dtype),
            torch.randn((b, d), generator=gen, device=device))


def lru_exact_decays(inputs):
    """``inputs`` with log_a of exactly 0 (a = 1, beta = 0: h carried
    unchanged) at every 37th step and -50 (a = 2e-22: a chunk's decay
    product underflows to 0, the carry resets) at every 41st."""
    la, gx, h0 = inputs
    la = la.clone()
    la[:, ::37] = 0.0
    la[:, 5::41] = -50.0
    return la, gx, h0


def lru_plain(la, gx, h0):
    """The public function's plain route: every h in gx's dtype, the final
    h in f32."""
    return rg_lru(la, gx, h0, return_state=True, use_ref=True)


def scan_check(plain32):
    """A check of a scan's (output, final state) against its plain version:
    in f32 within ``SCAN_TOL``; in bf16 within the bf16 limit of the f32
    plain version of the same (bf16-valued) inputs (``plain32``), with the
    gap to the plain version in bf16 reported beside it.  The kernels keep
    the state in f32 and round each output once, so the limit that holds an
    attention output holds these."""
    def check(name, got, want, *inputs):
        (out, state), (want_out, want_state) = got, want
        if out.dtype == torch.float32:
            e1 = check_close(name, out, want_out, rtol=SCAN_TOL, atol=SCAN_TOL)
            e2 = check_close(f"{name}/state", state, want_state,
                             rtol=SCAN_TOL, atol=SCAN_TOL)
            return max(e1[0], e2[0]), max(e1[1], e2[1])
        # The plain version in bf16 rounds where the kernel does not (the
        # WKV6 read, as the reference's wkv6_ref): its gap is reported, the
        # f32 plain version's is required.
        vs16 = bf16_gap(out, want_out)
        want32 = plain32(*as_f32(inputs))
        gap = bf16_check(name, out, want32[0])
        gap_state = bf16_check(f"{name}/state", state, want32[1])
        return gap["max_abs_err"], 0.0, {
            "bf16_limit_share": gap["limit_share"],
            "bf16_state_limit_share": gap_state["limit_share"],
            "bf16_plain_limit_share": vs16["limit_share"],
            "bf16_plain_max_abs_err": vs16["max_abs_err"]}
    return check


def scan_faults(kind: str, faults: dict, want32) -> list[dict]:
    """Outputs of wrong scans, made by the f32 plain computation and
    rounded to bf16 like a kernel's output, held to the bf16 limit: each
    must fail it."""
    rows = [{"fault": label, **bf16_gap(out.to(torch.bfloat16), want32)}
            for label, out in faults.items()]
    return require_caught(kind, rows)


wkv_check = scan_check(lambda *a: wkv6_ref(*a, return_state=True))
lru_check = scan_check(lru_plain)


def wkv_carry_fault(r, k, v, w, u, s0):
    """Route "chunk"'s three passes in plain PyTorch with one carried state
    not decayed across its chunk (P_c taken as 1 for the middle chunk)."""
    ds, decays = wkv6_chunk_updates(k, v, w, CHUNK_LEN)
    decays[:, :, decays.shape[2] // 2] = 1.0
    starts, _ = wkv6_chunk_carry(ds, decays, s0)
    return wkv6_chunk_outputs(r, k, v, w, u, starts, CHUNK_LEN)


def wkv_main_check(name, got, want, *inputs):
    """``wkv_check``, then planted faults: the bonus u dropped; one step's
    decay skipped (w = 1 at the middle step); the state zeroed in the
    middle of the sequence; route "chunk"'s carried state not decayed
    across the middle chunk."""
    abs_err, rel_err, extra = wkv_check(name, got, want, *inputs)
    r, k, v, w, u, s0 = as_f32(inputs)
    want32 = wkv6_ref(r, k, v, w, u, s0)
    mid = r.shape[2] // 2
    w_skip = w.clone()
    w_skip[:, :, mid] = 1.0
    halves = [wkv6_ref(r[:, :, sl], k[:, :, sl], v[:, :, sl], w[:, :, sl], u,
                       s) for sl, s in ((slice(0, mid), s0),
                                        (slice(mid, None),
                                         torch.zeros_like(s0)))]
    extra["planted_faults"] = scan_faults("wkv6", {
        "bonus_dropped": wkv6_ref(r, k, v, w, torch.zeros_like(u), s0),
        "decay_skipped_once": wkv6_ref(r, k, v, w_skip, u, s0),
        "state_zeroed_mid_sequence": torch.cat(halves, dim=2),
        "carry_not_decayed": wkv_carry_fault(r, k, v, w, u, s0),
    }, want32)
    return abs_err, rel_err, extra


#: the time step at which the planted fault resets the RG-LRU state: the
#: reference's block_t, the boundary of its first chunk, and a boundary of
#: route "chunk"'s chunks
LRU_RESET_AT = 256


def lru_carry_fault(la, gx, h0):
    """Route "chunk"'s three passes in plain PyTorch with one carried h not
    decayed across its chunk (A_c taken as 1 for the middle chunk)."""
    hloc, decays = rg_lru_chunk_local(la, gx, LRU_CHUNK_LEN)
    decays[:, decays.shape[1] // 2] = 1.0
    starts, _ = rg_lru_chunk_carry(hloc, decays, h0)
    return rg_lru_chunk_outputs(la, gx, starts, LRU_CHUNK_LEN)


def lru_main_check(name, got, want, *inputs):
    """``lru_check``, then planted faults: h0 ignored; beta taken as 1
    (h = a h + gx); the state reset at a chunk boundary; route "chunk"'s
    carried h not decayed across the middle chunk."""
    abs_err, rel_err, extra = lru_check(name, got, want, *inputs)
    la, gx, h0 = as_f32(inputs)
    want32 = rg_lru_scan(la, gx, h0)
    a = torch.exp(la)
    beta = torch.sqrt(torch.clamp(1.0 - a * a, min=0.0))
    c = min(LRU_RESET_AT, la.shape[1] // 2)
    extra["planted_faults"] = scan_faults("rg_lru", {
        "h0_ignored": rg_lru_scan(la, gx, None),
        "beta_one": rg_lru_scan(la, gx / beta, h0),
        "reset_at_chunk_boundary": torch.cat(
            [rg_lru_scan(la[:, :c], gx[:, :c], h0),
             rg_lru_scan(la[:, c:], gx[:, c:], None)], dim=1),
        "carry_not_decayed": lru_carry_fault(la, gx, h0),
    }, want32)
    return abs_err, rel_err, extra


def wkv_work(r, k, v, w, u, s0):
    """r, k, w, v read and the output written once, u, and the state read
    and written once; the fewest flops a step and head: 5 K V (the outer
    product k v^T, the dot of r with S, the decayed update w S + k v^T) and
    3 K + 2 V for the bonus term, which factors as (sum_k r u k) v.  At the
    f32 peak (the state is f32)."""
    b, h, t, dk = r.shape
    dv = v.shape[-1]
    return bound((3 * r.numel() + 2 * v.numel()) * r.element_size()
                 + 4.0 * (u.numel() + 2 * s0.numel()),
                 (5.0 * dk * dv + 3 * dk + 2 * dv) * t * b * h,
                 H100_SXM_FP32_FLOPS)


def lru_work(la, gx, h0):
    """log_a and gx read and h written once, h0 read and the final h
    written; 8 operations an element (exp, a^2, 1 - a^2, max, sqrt,
    beta gx, a h, the sum), at the f32 peak."""
    return bound(3.0 * gx.numel() * gx.element_size() + 8.0 * h0.numel(),
                 8.0 * gx.numel(), H100_SXM_FP32_FLOPS)


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_env(device: torch.device) -> dict:
    t0 = time.perf_counter()
    info = {"phase": "env", "torch": torch.__version__,
            "torch_cuda": torch.version.cuda}
    if device.type == "cuda":
        info["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            check=True, capture_output=True, text=True).stdout.strip()
        nvcc = subprocess.run([_build.find_nvcc(), "--version"], check=True,
                              capture_output=True, text=True).stdout
        info["nvcc"] = nvcc.strip().splitlines()[-2:]
        info["device_name"] = torch.cuda.get_device_name(0)
    info["seconds"] = time.perf_counter() - t0
    emit(info)
    return info


def demangled_name(mangled: str) -> str:
    """The last name of a mangled C++ symbol (``_ZN12_GLOBAL__N_13fooE...``
    gives ``foo``, ``_Z3barv`` gives ``bar``)."""
    pos = 3 if mangled.startswith("_ZN") else 2
    name = mangled
    while (m := re.match(r"\d+", mangled[pos:])):
        pos += len(m.group())
        name = mangled[pos:pos + int(m.group())]
        pos += int(m.group())
    return name


def sass_opcode_counts(text: str) -> dict:
    """``{kernel: {"total": n, opcode: n, ...}}`` from ``cuobjdump -sass``
    output: a static count (a loop body counts once), read against the
    bounds' operation counts.  Template instances get ``#1``, ``#2``."""
    counts, ops = {}, None
    for ln in text.splitlines():
        head = re.search(r"Function : (\S+)", ln)
        if head:
            name = demangled_name(head.group(1))
            seen = sum(k.split("#")[0] == name for k in counts)
            ops = counts.setdefault(f"{name}#{seen}" if seen else name, {})
            continue
        inst = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z]\w*)",
                        ln)
        if inst and ops is not None:
            ops[inst.group(1)] = ops.get(inst.group(1), 0) + 1
    return {fn: {"total": sum(o.values()), **dict(sorted(o.items()))}
            for fn, o in counts.items()}


def sass_text(lib) -> str:
    """``cuobjdump -sass`` of the built library, by the ``cuobjdump`` beside
    ``nvcc``."""
    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    return subprocess.run([cuobjdump, "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout


def sass_instructions(lib) -> dict:
    """Opcode counts of each kernel in the built library."""
    return sass_opcode_counts(sass_text(lib))


#: opcodes that issue on the FP32 pipe
FP32_OPS = ("FADD", "FMUL", "FFMA", "FSETP", "FSEL", "FMNMX", "FCHK")


def loop_slots(text: str, name: str) -> dict:
    """``{mangled name: counts}`` for each instance of kernel ``name`` in
    ``cuobjdump -sass`` output: the instructions of its innermost loop that
    holds a ``MUFU`` (the smallest range from a backward branch's target to
    the branch), by kind, and issue slots a pair, taking one ``MUFU`` (the
    rsqrt) to a pair."""
    bodies, lines = {}, None
    for ln in text.splitlines():
        head = re.search(r"Function : (\S+)", ln)
        if head:
            lines = (bodies.setdefault(head.group(1), [])
                     if demangled_name(head.group(1)) == name else None)
            continue
        inst = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                        r"([A-Z]\w*)(.*)", ln)
        if inst and lines is not None:
            target = re.search(r"0x([0-9a-f]+)", inst.group(3)) \
                if inst.group(2) == "BRA" else None
            lines.append((int(inst.group(1), 16), inst.group(2),
                          int(target.group(1), 16) if target else None))
    out = {}
    for fn, insts in bodies.items():
        loops = [[op for a, op, _ in insts if tgt <= a <= addr]
                 for addr, op, tgt in insts
                 if tgt is not None and tgt <= addr]
        loops = [ops for ops in loops if "MUFU" in ops]
        require(loops, name, "has no loop with a MUFU in its SASS")
        ops = min(loops, key=len)
        pairs = ops.count("MUFU")
        fp32 = sum(op in FP32_OPS for op in ops)
        lds = ops.count("LDS")
        out[fn] = {"pairs": pairs, "slots": len(ops), "fp32": fp32,
                   "mufu": pairs, "lds": lds,
                   "other": len(ops) - fp32 - pairs - lds,
                   "fsetp": ops.count("FSETP"),
                   "slots_per_pair": len(ops) / pairs,
                   "fp32_per_pair": fp32 / pairs, "lds_per_pair": lds / pairs}
    return out


#: the kernels of each route of the multi-route wrappers, by their names in
#: the SASS (a route of several launches names each), and the tensor-core
#: instruction every instance must hold: HGMMA (wgmma) or HMMA (mma.sync);
#: None: neither (the CUDA cores, so routes "pipe", "tri" and "chunk" are
#: true f32)
ROUTE_KERNELS = {
    "gemm_bf16": {"wgmma": (("gemm_wgmma_kernel",), "HGMMA"),
                  "fma": (("gemm_kernel",), None)},
    "gemm": {"pipe": (("gemm_pipe_kernel",), None),
             "fma": (("gemm_kernel",), None)},
    "flash_attention": {"wgmma": (("flash_wgmma_kernel",), "HGMMA"),
                        "fma": (("flash_attention_kernel",), None)},
    "decode_attention": {"mma": (("decode_mma_kernel",), "HMMA"),
                         "fma": (("decode_attention_kernel",), None)},
    "correlate": {"tri": (("correlate_tri_kernel",), None),
                  "fma": (("correlate_kernel",), None)},
    "wkv6": {"chunk": (("wkv6_deltas_kernel", "wkv6_carry_kernel",
                        "wkv6_outputs_kernel"), None),
             "fma": (("wkv6_kernel",), None)},
    "rg_lru": {"chunk": (("rg_lru_local_kernel", "rg_lru_outputs_kernel"),
                         None),
               "fma": (("rg_lru_kernel",), None)},
    "kmeans": {"private": (("kmeans_private_kernel",), None),
               "fma": (("kmeans_kernel",), None)},
    "spmv_ell": {"bin": (("spmv_finite_kernel", "spmv_bin_scatter_kernel",
                          "spmv_bin_gather_kernel"), None),
                 "fma": (("spmv_ell_kernel",), None)},
    "md5": {"unwind": (("md5_unwind_kernel",), None),
            "fma": (("md5_search_kernel",), None)},
    "nbody": {"tile": (("nbody_tile_kernel", "nbody_combine_kernel"), None),
              "fma": (("nbody_kernel",), None)},
}
TENSOR_CORE_OPS = ("HGMMA", "HMMA")
#: instances of the redesigned routes' kernels, whose spills ptxas reports:
#: GEMM wgmma 2 (bf16 and f32 out) and pipe 1, flash attention wgmma 3,
#: decode attention mma 6 (group and head-dim classes), correlator tri 2
#: (f32 and bf16 samples), wkv6 chunk 5 (its first and last passes for f32
#: and bf16, the carry once), rg_lru chunk 4 (both passes for f32 and
#: bf16), kmeans private 4 (one for each f of 2, 4, 8, 16), spmv_ell bin 3
#: (the finite pass, which route "fma" runs too, scatter, gather), md5
#: unwind 1, nbody tile 2 (the sums and the slices' combine)
REDESIGNED_INSTANCES = 33


def tensor_core_counts(sass: dict) -> dict:
    """Tensor-core instructions (HGMMA, HMMA) in each instance of the
    multi-route kernels (a static count): the route's own instruction in
    every instance of a tensor-core route, neither in a CUDA-core one."""
    out = {}
    for row, routes in ROUTE_KERNELS.items():
        out[row] = {}
        for route, (names, op) in routes.items():
            found = {}
            for name in names:
                these = {fn: {o: ops.get(o, 0) for o in TENSOR_CORE_OPS}
                         for fn, ops in sass.items()
                         if fn.split("#")[0] == name}
                require(these, row, "no kernel named", name, "in the SASS")
                found.update(these)
            for fn, n in found.items():
                ok = n[op] > 0 if op else not any(n.values())
                require(ok, row, fn, "holds", n, "tensor-core instructions; "
                        "route", route, "needs", op or "none")
            out[row][route] = found
    return out


#: the kernels of the redesigned routes (every route but "fma")
REDESIGNED_KERNELS = {name for routes in ROUTE_KERNELS.values()
                      for route, (kernels, _) in routes.items()
                      if route != "fma" for name in kernels}


def ptxas_usage(log: str, names=REDESIGNED_KERNELS) -> dict:
    """``{kernel#i: {"spill_bytes": n, "registers": n}}`` for each instance
    of the kernels ``names``, from ptxas' report in the build log (its
    entry line, then its spill stores and loads, then its registers)."""
    usage, name = {}, None
    for ln in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", ln)
        if entry:
            name = demangled_name(entry.group(1))
            name = name if name in names else None
            if name:
                name += f"#{sum(k.split('#')[0] == name for k in usage)}"
                usage[name] = {}
            continue
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                           r"loads", ln)
        regs = re.search(r"Used (\d+) registers", ln)
        if name and spills:
            usage[name]["spill_bytes"] = (int(spills.group(1))
                                          + int(spills.group(2)))
        if name and regs:
            usage[name]["registers"] = int(regs.group(1))
    return usage


def phase_build(device: torch.device) -> dict:
    t0 = time.perf_counter()
    info = {"phase": "build"}
    if device.type == "cuda":
        _build.load()
        info["nvcc_seconds"] = _build.build_seconds
        info["sources"] = [p.name for p in _build.sources()]
        text = sass_text(_build.build())
        info["sass"] = sass_opcode_counts(text)
        info["tensor_cores"] = tensor_core_counts(info["sass"])
        # N-Body's issue slots a pair in each route's inner loop; route
        # "tile"'s rsqrt must be MUFU.RSQ with no test around it.
        slots = {route: loop_slots(text, kernels[0])
                 for route, (kernels, _) in ROUTE_KERNELS["nbody"].items()}
        require(all(len(v) == 1 for v in slots.values()), slots)
        info["nbody_slots_per_pair"] = {r: next(iter(v.values()))
                                        for r, v in slots.items()}
        require(info["nbody_slots_per_pair"]["tile"]["fsetp"] == 0,
                "route tile's rsqrt is guarded:", slots)
        # Registers, shared memory and spills of each kernel, from ptxas.
        log = _build.build_log()
        lines = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
        print("\n".join(lines), file=sys.stderr)
        usage = ptxas_usage(log)
        info["spill_bytes"] = {k: u.get("spill_bytes") for k, u in
                               usage.items()}
        info["registers"] = {k: u.get("registers") for k, u in usage.items()}
        require(len(info["spill_bytes"]) == REDESIGNED_INSTANCES
                and None not in info["spill_bytes"].values(),
                "ptxas reported", info["spill_bytes"], "for the",
                REDESIGNED_INSTANCES, "instances of the redesigned routes")
        require(not any(info["spill_bytes"].values()),
                "a redesigned kernel spills:", info["spill_bytes"])
    else:
        info["skipped"] = "rehearsal on the CPU: nothing to build"
    info["seconds"] = time.perf_counter() - t0
    emit(info)
    return info


def kernel_cases(sizes: Sizes, device: torch.device, gen: torch.Generator):
    """One dict per kernel entry: how to make inputs at the main-path shape
    and at a ragged shape of the reference sweep, the public function, the
    plain version, an optional library call, the tolerance with its
    reason, and the least work the function needs."""
    g = sizes.gemm

    def kmeans_make(n, k, f):
        return kmeans_inputs(n, k, f, gen, device)

    def csums_check(name, got, want, z):
        err = check_close(name, got, want, rtol=1e-4, atol=1e-3)
        mass, total = float(got.double().sum()), float(z.double().sum())
        if abs(mass - total) > 1e-4 * abs(total):
            raise AssertionError(f"{name}: mass {mass} != {total}")
        return err

    def md5_check(name, got, want, n, target, expect, route):
        require(int(got) == int(want) == expect, name, "found", int(got),
                "plain", int(want), "expected", expect)
        return 0.0, 0.0

    def md5_main_check(name, got, want, n, target, expect, route):
        """Kernel and plain version over all n keys, the kernel once more
        with no key matching, and the planted faults of route "unwind"
        (``md5_faults``), each of which must miss the key."""
        md5_check(name, got, want, n, target, expect, route)
        none = int(md5_search(n, MD5_NO_MATCH, device=device))
        require(none == n, name, "no-match search gave", none, "not", n)
        faults = md5_faults(n, target, expect, device) \
            if device.type == "cuda" else []
        return 0.0, 0.0, {"planted_faults": faults}

    def nbody_main_check(name, got, want, posm, softening2):
        """Every target against the f32 plain version within
        ``2e-4 * sum_j |term_ij|`` (two f32 sums of n terms, each held to
        1e-4 of it below), then a slab of targets, kernel and plain
        version both, against float64; then route "tile"'s planted faults
        (``nbody_fault_rows``) at its ragged shape, each of which must fail
        that limit."""
        n, s = posm.shape[0], sizes.nbody_slab
        for lo in range(0, n, s):
            hi = min(n, lo + s)
            err = (got[lo:hi] - want[lo:hi]).abs()
            limit = 2e-4 * nbody_term_scale(posm, lo, hi)
            if not torch.isfinite(got[lo:hi]).all() or (err > limit).any():
                raise AssertionError(
                    f"{name}: targets {lo}:{hi} off the f32 plain version "
                    f"by {float((err / limit).max()):.3e} of the limit")
        lo = (n - s) // 2
        err = nbody_slab_check(name, got[lo:lo + s], want[lo:lo + s], posm,
                               lo, lo + s)
        faults = nbody_fault_rows(nbody_inputs(
            NBODY_RAGGED_TILE, gen, device, zero_every=7)[0])
        return (*err, {"planted_faults": faults,
                       "ordered_floor_ms": nbody_ordered_floor_ms(n)})

    f32, bf16 = torch.float32, torch.bfloat16


    def gemm_case(name, dtype, rate, route):
        return dict(
            name=name, wrapper="gemm", source="src/repro_torch/csrc/gemm.cu",
            replaces="src/repro/kernels/gemm/kernel.py:66",
            main=lambda: gemm_inputs(g, g, g, dtype, gen, device),
            main_route=route,
            # K = 60: 120-byte rows, which TMA refuses (route "fma" in bf16
            # too); (200, 136, 264): aligned, ragged in all three axes
            # (bf16 by "wgmma", f32 by "fma": K not whole 16-deep stages);
            # (200, 144, 260): f32 by "pipe", ragged in M and N
            ragged=lambda: [gemm_inputs(100, 60, 130, dtype, gen, device),
                            gemm_inputs(200, 136, 264, dtype, gen, device),
                            gemm_inputs(200, 144, 260, dtype, gen, device)],
            fn=lambda a, b: gemm(a, b),
            plain=lambda a, b: gemm_ref(a, b),
            library=lambda a, b: torch.matmul(a, b),
            check=gemm_check,
            main_check=gemm_main_check,
            work=lambda a, b: bound(
                (a.numel() + b.numel() + a.shape[0] * b.shape[1])
                * a.element_size(),
                2.0 * a.shape[0] * a.shape[1] * b.shape[1], rate),
            shape=lambda a, b: [a.shape[0], a.shape[1], b.shape[1]],
            first=lambda a, b: gemm_cuda(a, b, route="fma"),
        )

    return [
        # The launch phase's K-Means at (n, f, k) = (2^26, 4, 40) and the
        # stream phase's chunk of 2^22 rows, by route "private" (its first
        # version, route "fma", timed beside it); ragged, (n, k, f): the
        # sweep's (1000, 7, 4) and each other specialised f by "private";
        # by "fma" f = 3 and k (f + 1) past what a thread's accumulators
        # hold ((1000, 50, 4), (2000, 20, 16), (2000, 400, 16)).
        dict(
            name="kmeans", wrapper="kmeans",
            source="src/repro_torch/csrc/kmeans.cu",
            replaces="src/repro/kernels/kmeans/kernel.py:57",
            main=lambda: kmeans_make(sizes.kmeans_n, KM_K, KM_F),
            main_route="private",
            also={"stream_chunk": lambda: kmeans_make(
                sizes.stream_chunk_rows, KM_K, KM_F)},
            ragged=lambda: [kmeans_make(1000, 7, 4), kmeans_make(1000, 7, 3),
                            kmeans_make(5001, 9, 2), kmeans_make(3000, 5, 8),
                            kmeans_make(2000, 6, 16),
                            kmeans_make(1000, 50, 4),
                            kmeans_make(2000, 20, 16),
                            kmeans_make(2000, 400, 16)],
            first=lambda p, c: tuple(x.sum(dim=0) for x in kmeans_cuda(
                p, c, route="fma")),
            fn=lambda p, c: kmeans_assign_reduce(p, c),
            plain=lambda p, c: kmeans_assign_reduce_ref(p, c),
            library=None,
            # counts exact (integers; inputs have separated clusters);
            # sums rtol 1e-4 atol 1e-3: another order of summation.
            check=lambda nm, got, want, *inp: kmeans_check(nm, got, want,
                                                           inp[0]),
            work=lambda p, c: bound(
                (p.numel() + 2 * c.numel() + c.shape[0]) * 4,
                p.shape[0] * (c.shape[0] * (2.0 * p.shape[1] + 3)
                              + 2.0 * p.shape[1]),
                H100_SXM_FP32_FLOPS),
            shape=lambda p, c: [p.shape[0], p.shape[1], c.shape[0]],
        ),
        dict(
            name="hotspot", wrapper="hotspot",
            source="src/repro_torch/csrc/hotspot.cu",
            replaces="src/repro/kernels/stencil2d/kernel.py:69",
            main=lambda: hotspot_inputs(sizes.hotspot, gen, device),
            ragged=lambda: hotspot_inputs((33, 128), gen, device),
            fn=lambda t, p: hotspot_step(t, p),
            plain=lambda t, p: hotspot_step_ref(t, p),
            library=None,
            # rtol 2e-5 atol 2e-4: the reference sweep's, for rounding.
            check=lambda nm, got, want, *inp: check_close(
                nm, got, want, rtol=2e-5, atol=2e-4),
            work=lambda t, p: bound(3 * t.numel() * 4, 15.0 * t.numel(),
                                    H100_SXM_FP32_FLOPS),
            shape=lambda t, p: list(t.shape),
        ),
        dict(
            name="cluster_sums", wrapper="cluster_sums",
            source="src/repro_torch/csrc/cluster_sums.cu",
            replaces="src/repro/kernels/coclustering/kernel.py:51",
            main=lambda: csums_inputs(sizes.csums, gen, device),
            ragged=lambda: csums_inputs((500, 64), gen, device),
            fn=lambda z, ra, ca: cluster_sums(z, ra, ca, CS_R, CS_C),
            plain=lambda z, ra, ca: cluster_sums_ref(z, ra, ca, CS_R, CS_C),
            library=None,
            # rtol 1e-4 atol 1e-3, mass rtol 1e-4: order of summation.
            check=lambda nm, got, want, *inp: csums_check(nm, got, want,
                                                          inp[0]),
            work=lambda z, ra, ca: bound(
                (z.numel() + ra.numel() + ca.numel() + CS_R * CS_C) * 4,
                float(z.numel()), H100_SXM_FP32_FLOPS),
            shape=lambda z, ra, ca: list(z.shape),
        ),
        # f32: true f32 products on the CUDA cores, loads a stage ahead;
        # bf16: the tensor cores; each with its first version (route "fma")
        # timed beside it (GEMM_TOL).
        gemm_case("gemm", torch.float32, H100_SXM_FP32_FLOPS, "pipe"),
        gemm_case("gemm_bf16", torch.bfloat16, H100_SXM_BF16_FLOPS, "wgmma"),
        dict(
            name="black_scholes", wrapper="black_scholes",
            source="src/repro_torch/csrc/black_scholes.cu",
            replaces="src/repro/kernels/black_scholes/kernel.py:56",
            main=lambda: bs_inputs(sizes.bs_n, gen, device),
            # 1000 (16-byte path only), 1003 (scalar tail) and a view one
            # element in (not 16-byte aligned: scalar path throughout)
            ragged=lambda: [bs_inputs(1000, gen, device),
                            bs_inputs(1003, gen, device),
                            tuple(t[1:] for t in bs_inputs(1002, gen, device))],
            fn=lambda s, k, t: black_scholes(s, k, t),
            plain=lambda s, k, t: black_scholes_ref(s, k, t),
            library=None,
            check=lambda nm, got, want, *inp: bs_check(nm, got, want, *inp),
            # 20 bytes an option; 27 operations an option counting sqrtf,
            # logf, erff (x2) and expf as one each, 22 adds, multiplies
            # and divides besides.
            work=lambda s, k, t: bound(20.0 * s.numel(), 27.0 * s.numel(),
                                       H100_SXM_FP32_FLOPS),
            shape=lambda s, k, t: [s.numel()],
        ),
        # The launch phase's SpMV, (2^25, 16) with x of 2^25 columns (128
        # MiB, past L2), by route "bin" (its first version, route "fma",
        # timed beside it); ragged: 300 rows by "fma" (16 entries a row:
        # 16-byte loads, 4 lanes a row; 13: single loads, 16 lanes), and
        # a ragged shape by "bin" with columns out of range, without and
        # with NaN in x under zero entries.
        dict(
            name="spmv_ell", wrapper="spmv_ell",
            source="src/repro_torch/csrc/spmv_ell.cu",
            replaces="src/repro/kernels/spmv_ell/kernel.py:43",
            main=lambda: spmv_inputs(sizes.spmv[0], sizes.spmv[1],
                                     sizes.spmv[0], gen, device),
            main_route="bin",
            ragged=lambda: [spmv_ragged_inputs(16, gen, device),
                            spmv_ragged_inputs(13, gen, device),
                            spmv_bin_inputs(sizes.spmv_bin_ragged, gen,
                                            device),
                            spmv_bin_inputs(sizes.spmv_bin_ragged, gen,
                                            device, nan_under_zeros=True)],
            first=lambda d, c, x: spmv_ell_cuda(d, c, x, route="fma"),
            fn=lambda d, c, x: spmv_ell(d, c, x),
            plain=lambda d, c, x: spmv_ell_ref(d, c, x),
            library=lambda csr, x: torch.mv(csr, x),
            library_setup=ell_to_csr,
            check=spmv_check,
            main_check=lambda nm, got, want, *inp: (
                *spmv_check(nm, got, want),
                {"planted_faults": spmv_bin_faults(sizes.spmv_bin_ragged,
                                                   gen, device)}),
            # data, cols and y once, x once; the random gather reads a
            # 32-byte sector per entry, so the real traffic is larger.
            work=lambda d, c, x: bound(
                (d.numel() + c.numel() + d.shape[0] + x.numel()) * 4.0,
                2.0 * d.numel(), H100_SXM_FP32_FLOPS),
            shape=lambda d, c, x: [d.shape[0], d.shape[1], x.numel()],
        ),
        # The launch phase's two searches of 2^30 keys, by route "unwind"
        # (its first version, route "fma", timed beside it); ragged: n =
        # 2048 with the key at 0, at 1500 and nowhere, by "unwind" and by
        # "fma".  An input is (n, target, expected index, route named).
        dict(
            name="md5", wrapper="md5",
            source="src/repro_torch/csrc/md5.cu",
            replaces="src/repro/kernels/md5/kernel.py:52",
            main=lambda: (sizes.md5_n,
                          md5_digest(sizes.md5_n - MD5_PLANT_BELOW_N),
                          sizes.md5_n - MD5_PLANT_BELOW_N, None),
            main_route="unwind",
            ragged=lambda: [(2048, md5_digest(0), 0, None),
                            (2048, md5_digest(1500), 1500, None),
                            (2048, MD5_NO_MATCH, 2048, None),
                            (2048, md5_digest(1500), 1500, "fma"),
                            (2048, MD5_NO_MATCH, 2048, "fma")],
            first=lambda n, t, e, r: md5_search_cuda(n, t, device,
                                                     route="fma"),
            fn=lambda n, t, e, r: (
                md5_search(n, t, device=device)
                if r is None or device.type != "cuda"
                else md5_search_cuda(n, t, device, route=r)[0]),
            plain=lambda n, t, e, r: md5_search_ref(n, t, device=device),
            plain_reps=1,
            library=None,
            # exact: an index
            check=md5_check,
            main_check=md5_main_check,
            # every key runs rounds 1-52 (no early exit), 16 bytes of
            # target read, one int written
            work=lambda n, t, e, r: md5_work(n),
            shape=lambda n, t, e, r: [n],
        ),
        # The launch phase's 2^17 bodies by route "tile" (its first
        # version, route "fma", timed beside it); ragged: n = 300 by "fma",
        # a last source tile of 37 bodies with every 7th mass zero by
        # "tile", and eps^2 = 0 by "fma" (NaN wherever the plain version
        # has it).  An input is (posm, eps^2).
        dict(
            name="nbody", wrapper="nbody",
            source="src/repro_torch/csrc/nbody.cu",
            replaces="src/repro/kernels/nbody/kernel.py:64",
            main=lambda: nbody_inputs(sizes.nbody_n, gen, device),
            main_route="tile",
            ragged=lambda: [nbody_inputs(300, gen, device),
                            nbody_inputs(NBODY_RAGGED_TILE, gen, device,
                                         zero_every=7),
                            nbody_inputs(300, gen, device, softening2=0.0)],
            first=lambda p, e: nbody_cuda(p, softening2=e, route="fma"),
            fn=lambda p, e: nbody_forces(p, softening2=e),
            plain=lambda p, e: nbody_forces_ref(p, e),
            plain_reps=1,
            library=None,
            # 1e-4 of sum |term| against float64 (nbody_check; the main
            # shape by nbody_main_check).
            check=nbody_check,
            main_check=nbody_main_check,
            work=lambda p, e: bound(
                p.shape[0] * 28.0,
                float(p.shape[0]) ** 2 * NBODY_FLOPS_PER_PAIR,
                H100_SXM_FP32_FLOPS),
            shape=lambda p, e: [p.shape[0]],
        ),
        # The serving path's prefill at phi3-mini's width, causal, bf16;
        # gemma-2b's MQA (8 query heads on one kv head of 256 dims) held
        # and timed beside it (not a shape of the serving path: no
        # launches of its own); ragged and f32 cases of the reference sweep.
        dict(
            name="flash_attention", wrapper="flash_attention",
            source="src/repro_torch/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention/kernel.py:110",
            main=lambda: flash_inputs(sizes.flash, bf16, gen, device),
            main_route="wgmma",
            also={"gemma": lambda: flash_inputs(sizes.flash_gemma, bf16,
                                                gen, device)},
            # f32 (route "fma") and bf16 (route "wgmma": the TMA boxes'
            # zero fill at ragged S and T, D = 96 and 256, the masks)
            ragged=lambda: [
                flash_inputs((1, 8, 2, 256, 64), f32, gen, device),  # GQA
                flash_inputs((1, 4, 1, 128, 32), f32, gen, device,
                             window=64),  # sliding window
                flash_inputs((2, 4, 2, 100, 32), f32, gen, device),  # S=100
                flash_inputs((1, 4, 2, 40, 32), f32, gen, device, t=100,
                             q_offset=60),  # q_offset > 0, S < T, ragged T
                flash_inputs((1, 4, 4, 128, 64), bf16, gen, device),
                flash_inputs((1, 8, 1, 130, 256), f32, gen, device),  # MQA
                flash_inputs((1, 8, 2, 100, 96), bf16, gen, device),
                flash_inputs((1, 10, 1, 300, 256), bf16, gen, device,
                             window=64),
                flash_inputs((1, 4, 2, 40, 96), bf16, gen, device, t=100,
                             q_offset=60),
            ],
            first=lambda q, k, v, kw: flash_attention_cuda(
                q, k, v, route="fma", **kw),
            fn=lambda q, k, v, kw: flash_attention(q, k, v, **kw),
            plain=lambda q, k, v, kw: attention_ref(q, k, v, **kw),
            library=lambda q, k, v, kw: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True),
            check=flash_check,
            main_check=flash_main_check,
            work=flash_work,
            queued=KERNEL_HOST_S,
            shape=lambda q, k, v, kw: [q.shape[0], q.shape[1], k.shape[1],
                                       q.shape[2], k.shape[2], q.shape[3]],
        ),
        # The serving paths' decode steps: phi3-mini's (8 slots, kv_len
        # over [1, T]) and recurrentgemma-2b's ring buffer (10 query heads
        # on one kv head of 256); gemma-2b's MQA beside them, as for flash
        # attention.  bf16 takes the tensor cores (route "mma"), its first
        # version (route "fma") timed beside it.
        dict(
            name="decode_attention", wrapper="decode_attention",
            source="src/repro_torch/csrc/decode_attention.cu",
            replaces="src/repro/kernels/decode_attention/kernel.py:94",
            main=lambda: decode_inputs(sizes.decode, bf16, gen, device),
            main_route="mma",
            also={"gemma": lambda: decode_inputs(sizes.decode_gemma, bf16,
                                                 gen, device),
                  "recurrentgemma": lambda: decode_inputs(
                      sizes.decode_rgemma, bf16, gen, device)},
            # f32 (route "fma") and bf16 (route "mma": T ragged, G = 10 and
            # 32 query heads a kv head, rows at kv_len 1 and T)
            ragged=lambda: [
                decode_inputs((2, 8, 2, 512, 64), f32, gen, device),
                decode_inputs((1, 4, 4, 300, 32), f32, gen, device,
                              kv_len=1),
                decode_inputs((2, 4, 1, 256, 64), f32, gen, device),
                decode_inputs((8, 32, 32, 300, 96), bf16, gen, device),
                decode_inputs((2, 8, 1, 300, 256), f32, gen, device),
                decode_inputs((3, 10, 1, 300, 256), bf16, gen, device),
                decode_inputs((2, 32, 1, 200, 128), bf16, gen, device),
            ],
            first=lambda q, k, v, n: decode_attention_cuda(
                q, k, v, n, route="fma"),
            fn=lambda q, k, v, n: decode_attention(q, k, v, kv_len=n,
                                                   with_lse=True),
            plain=lambda q, k, v, n: decode_attention_ref(
                q, k, v, kv_len=n, with_lse=True),
            library=lambda q4, k, v, m: F.scaled_dot_product_attention(
                q4, k, v, attn_mask=m, enable_gqa=True),
            library_setup=sdpa_decode_setup,
            check=decode_check,
            main_check=decode_main_check,
            work=decode_work,
            queued=KERNEL_HOST_S,
            shape=lambda q, k, v, n: [q.shape[0], q.shape[1], k.shape[1],
                                      k.shape[2], q.shape[2]],
        ),
        # The paper's correlator at (C, T, A) = (1024, 768, 256) f32, the
        # size of the launch phase, by route "tri" (the tiles with i <= j,
        # the rest mirrored), its first version (route "fma") timed beside
        # it; ragged T and A, and the sweep's shapes: A <= 64 by "fma", A =
        # 200 (rows 16-byte aligned) and 65 (a last tile of one antenna,
        # rows not aligned) by "tri", in f32 and bf16.
        dict(
            name="correlate", wrapper="correlate",
            source="src/repro_torch/csrc/correlator.cu",
            replaces="src/repro/kernels/correlator/kernel.py:62",
            main=lambda: corr_inputs(*sizes.corr, gen, device),
            main_route="tri",
            ragged=lambda: [corr_inputs(3, 77, 37, gen, device),
                            corr_inputs(2, 513, 64, gen, device),
                            corr_inputs(4, 100, 16, gen, device),
                            corr_inputs(3, 77, 37, gen, device, bf16),
                            corr_inputs(3, 77, 200, gen, device),
                            corr_inputs(3, 77, 200, gen, device, bf16),
                            corr_inputs(2, 33, 65, gen, device),
                            corr_inputs(2, 33, 65, gen, device, bf16)],
            first=lambda x: correlate_cuda(x, route="fma"),
            fn=lambda x: correlate(x),
            plain=lambda x: correlate_ref(x),
            library=lambda x: torch.matmul(x.mT, x.conj()),
            library_setup=corr_setup,
            check=corr_check,
            main_check=corr_main_check,
            work=corr_work,
            shape=lambda x: list(x.shape[:3]),
        ),
        # rwkv6-3b's prefill of 2048 tokens, bf16, by route "chunk" (its
        # first version, route "fma", timed beside it), and its 8-slot
        # decode step beside it by "fma"; ragged T, K and V in f32 and
        # bf16: T under two chunks by "fma"; by "chunk" T not a multiple
        # of the chunk (300, 161), V = 50, K = 20 (staged a channel at a
        # time) and decays of exactly 0 and 1.
        dict(
            name="wkv6", wrapper="wkv6",
            source="src/repro_torch/csrc/wkv6.cu",
            replaces="src/repro/kernels/rwkv6/kernel.py:75",
            main=lambda: wkv_inputs(*sizes.wkv, sizes.wkv[-1], bf16, gen,
                                    device),
            main_route="chunk",
            also={"decode": lambda: wkv_inputs(*sizes.wkv_decode,
                                               sizes.wkv_decode[-1], bf16,
                                               gen, device)},
            also_route={"decode": "fma"},
            also_check=wkv_check,
            ragged=lambda: [wkv_inputs(2, 3, 45, 16, 8, f32, gen, device),
                            wkv_inputs(1, 4, 70, 64, 64, f32, gen, device),
                            wkv_inputs(2, 2, 33, 20, 50, bf16, gen, device),
                            wkv_inputs(1, 4, 300, 64, 64, f32, gen, device),
                            wkv_inputs(1, 4, 300, 64, 64, bf16, gen, device),
                            wkv_inputs(2, 3, 161, 64, 50, f32, gen, device),
                            wkv_inputs(2, 3, 161, 64, 50, bf16, gen, device),
                            wkv_inputs(2, 2, 200, 20, 50, f32, gen, device),
                            wkv_exact_decays(wkv_inputs(1, 4, 300, 64, 64,
                                                        f32, gen, device))],
            first=lambda r, k, v, w, u, s0: wkv6_cuda(r, k, v, w, u, s0,
                                                      route="fma"),
            fn=lambda r, k, v, w, u, s0: wkv6(r, k, v, w, u, s0,
                                              return_state=True),
            plain=lambda r, k, v, w, u, s0: wkv6_ref(r, k, v, w, u, s0,
                                                     return_state=True),
            library=None,
            check=wkv_check,
            main_check=wkv_main_check,
            work=wkv_work,
            queued=KERNEL_HOST_S,
            shape=lambda r, k, v, w, u, s0: [*r.shape, v.shape[-1]],
        ),
        # recurrentgemma-2b's prefill of 2048 tokens, bf16, by route "chunk"
        # (its first version, route "fma", timed beside it), and its 8-slot
        # decode step beside it by "fma"; ragged T and D in f32 and bf16:
        # T under three chunks (the sweep's, and 161 at full width) by
        # "fma"; by "chunk" T not a multiple of the chunk (300, 4170),
        # D = 100, log_a of exactly 0 (a = 1) and -50 (a underflows in a
        # chunk's product), and T = 4170 (over 64 chunks of 64: 64 chunks
        # of 66 instead).
        dict(
            name="rg_lru", wrapper="rg_lru",
            source="src/repro_torch/csrc/rg_lru.cu",
            replaces="src/repro/kernels/rg_lru/kernel.py:69",
            main=lambda: lru_inputs(*sizes.lru, bf16, gen, device),
            main_route="chunk",
            also={"decode": lambda: lru_inputs(*sizes.lru_decode, bf16, gen,
                                               device)},
            also_route={"decode": "fma"},
            also_check=lru_check,
            ragged=lambda: [lru_inputs(2, 50, 100, f32, gen, device,
                                       sweep=True),
                            lru_inputs(2, 96, 256, f32, gen, device),
                            lru_inputs(3, 37, 70, bf16, gen, device),
                            lru_inputs(2, 300, 100, f32, gen, device),
                            lru_inputs(2, 300, 100, bf16, gen, device),
                            lru_inputs(3, 161, 2560, bf16, gen, device),
                            lru_exact_decays(lru_inputs(2, 300, 100, f32,
                                                        gen, device)),
                            lru_exact_decays(lru_inputs(2, 300, 100, bf16,
                                                        gen, device)),
                            lru_inputs(1, 4170, 100, f32, gen, device)],
            first=lambda la, gx, h0: rg_lru_cuda(la, gx, h0, route="fma"),
            fn=lambda la, gx, h0: rg_lru(la, gx, h0, return_state=True),
            plain=lru_plain,
            library=None,
            check=lru_check,
            main_check=lru_main_check,
            work=lru_work,
            queued=KERNEL_HOST_S,
            shape=lambda la, gx, h0: list(gx.shape),
        ),
    ]


def routed(wrapper, fn, device):
    """``fn()`` and the route its one launch took, by the wrapper's
    ``routes`` counts (None for a one-route wrapper or on the CPU)."""
    before = dict(getattr(wrapper, "routes", {}))
    out = fn()
    taken = [r for r, n in getattr(wrapper, "routes", {}).items()
             if n != before[r]]
    require(len(taken) <= 1, "one call took routes", taken)
    return out, (taken[0] if taken and device.type == "cuda" else None)


def measure(case: dict, inputs, sizes: Sizes, device: torch.device,
            check=None, route_wanted=None) -> dict:
    """One shape of a kernel: its result held against the plain version
    (``check``, else ``main_check``, else ``check`` of the case), then the
    kernel, the plain version and the library call timed, and the bound of
    the work, and for a two-route kernel the route it took (which must be
    ``route_wanted``, else the case's ``main_route``) and, where that is
    not the first version, the first version's time on the same inputs."""
    wrapper = WRAPPERS[case["wrapper"]]
    got, route = routed(wrapper, lambda: case["fn"](*inputs), device)
    route_wanted = route_wanted or case.get("main_route")
    if route_wanted and device.type == "cuda":
        require(route == route_wanted, case["name"], "took route",
                route, "not", route_wanted)
    sync(device)
    plain_reps = case.get("plain_reps", sizes.reps)
    plain_ms = None
    if plain_reps == 1:
        # A plain version that takes seconds runs once, timed, and that run
        # is the one the kernel is held against.
        kept = []
        plain_ms = time_ms(lambda: kept.append(case["plain"](*inputs)),
                           device, 1, warmup=False)
        want = kept.pop()
    else:
        want = case["plain"](*inputs)
    check = check or case.get("main_check", case["check"])
    abs_err, rel_err, *extra = check(
        f"{case['name']}/{list(case['shape'](*inputs))}", got, want, *inputs)
    first = want[0] if isinstance(want, tuple) else want
    require(float(first.abs().max()) > 0, case["name"], "compared all zeros")
    del got, want, first
    queued = case.get("queued", 0.0)
    if plain_reps > 1:
        plain_ms = time_ms(lambda: case["plain"](*inputs), device,
                           plain_reps, queued=queued)
    bound_ms, bound_by = case["work"](*inputs)
    library_ms = None
    if case["library"]:
        lib_inputs = case.get("library_setup", lambda *a: a)(*inputs)
        library_ms = time_ms(lambda: case["library"](*lib_inputs),
                             device, sizes.reps, queued=queued)
        del lib_inputs
    first = {}
    if case.get("first") and route_wanted != "fma" and device.type == "cuda":
        first = {"first_version_route": "fma", "first_version_ms": time_ms(
            lambda: case["first"](*inputs), device, sizes.reps,
            queued=queued)}
    return {
        "max_abs_err": abs_err, "max_rel_err": rel_err,
        **({"kernel_route": route} if route else {}), **first,
        "ms": time_ms(lambda: case["fn"](*inputs), device, sizes.reps,
                      queued=queued),
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms, "shape": case["shape"](*inputs),
        **(extra[0] if extra else {}),
    }


def phase_kernels(sizes: Sizes, device: torch.device,
                  gen: torch.Generator, build: dict) -> list[dict]:
    """Each kernel against its plain version on the card, at ragged shapes,
    then at the main-path shape (and at the shapes in ``also``), where it is
    also timed.  A two-route kernel's ragged cases must take route "fma"
    at least once, and its row carries the HGMMA counts of ``build``."""
    t0 = time.perf_counter()
    # The plain versions multiply in true f32, like the kernels.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = []
    for case in kernel_cases(sizes, device, gen):
        name = case["name"]
        wrapper = WRAPPERS[case["wrapper"]]
        raggeds = case["ragged"]()
        if not isinstance(raggeds, list):
            raggeds = [raggeds]
        ragged_err, ragged_routes = 0.0, []
        for inputs in raggeds:
            before = wrapper.launches
            got, route = routed(wrapper, lambda: case["fn"](*inputs), device)
            sync(device)
            if device.type == "cuda" and wrapper.launches != before + 1:
                raise AssertionError(f"{name}: the wrapper did not launch")
            ragged_routes.append(route)
            ragged_err = max(ragged_err, case["check"](
                f"{name}/ragged", got, case["plain"](*inputs), *inputs)[0])
        ragged_shape = case["shape"](*raggeds[0])
        del raggeds, inputs, got
        if case.get("main_route") and device.type == "cuda":
            require({"fma", case["main_route"]} <= set(ragged_routes), name,
                    "ragged cases took only", ragged_routes)

        row = {"name": name, "route": "cuda", "source": case["source"],
               "replaces": case["replaces"], "launches": None,
               **measure(case, case["main"](), sizes, device),
               "ragged_shape": ragged_shape,
               "ragged_max_abs_err": ragged_err,
               **({"ragged_routes": ragged_routes}
                  if any(ragged_routes) else {}),
               **({"tensor_cores": build["tensor_cores"][name]}
                  if name in build.get("tensor_cores", {}) else {})}
        for label, make in case.get("also", {}).items():
            row[label] = measure(case, make(), sizes, device,
                                 case.get("also_check"),
                                 case.get("also_route", {}).get(label))
        if case.get("plain_reps", sizes.reps) != sizes.reps:
            row["plain_runs"] = case["plain_reps"]
        if case.get("queued"):
            row["timing"] = (f"mean of {sizes.reps} back-to-back calls "
                             "queued behind a device sleep: device time")
        rows.append(row)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    emit({"phase": "kernels", "tf32": False, "rows": rows,
          "seconds": time.perf_counter() - t0})
    return rows


#: workers of the launch phase's mesh pass, all on the one GPU
MESH_WORKERS = 4


def halo_stencil_body(views, info):
    """The 1-D stencil on a view with a cell of each neighbour on either
    side (zeros at the two end shards); the whole array (one worker) gets
    the same zeros.  Sums in the launch phase's order: (left + x) + right."""
    x = views["input"]
    if x.shape[0] == info.grid[0]:
        zero = torch.zeros((1,), dtype=x.dtype, device=x.device)
        x = torch.cat([zero, x, zero])
    return {"output": (x[:-2] + x[1:-1] + x[2:]) / 3.0}


def halo_hotspot_body(views, info):
    """One HotSpot step on a worker's slab: the halo row at either end of
    the grid (zeros) is dropped so that the kernel's own clamp applies
    there, the neighbours' rows are kept for the stencil and their outputs
    dropped; power (LOCAL) is padded to the slab.  On one worker the slab
    is the whole grid."""
    slab, power = views["temp"], views["power"]
    if slab.shape[0] == info.grid[0]:
        return {"out": hotspot_step(slab, power)}
    top = info.thread_offset[0] == 0
    bottom = info.thread_offset[0] + info.local_shape[0] == info.grid[0]
    slab = slab[int(top): slab.shape[0] - int(bottom)]
    pad = power.new_zeros((1, power.shape[1]))
    power = torch.cat([pad] * (not top) + [power] + [pad] * (not bottom))
    out = hotspot_step(slab.contiguous(), power)
    return {"out": out[int(not top): out.shape[0] - int(not bottom)]}


def kmeans_body(views, info):
    sums, counts = kmeans_assign_reduce(views["points"], views["centroids"])
    return {"sums": sums, "counts": counts}


def md5_prefix_body(views, info):
    """MD5 on a worker: the kernel searches from key 0, so the worker
    searches up to the end of its range, and its own no-match (the end)
    becomes the grid's n; the smallest over the workers is the smallest
    overall.  On one worker, the whole grid."""
    n = info.grid[0]
    end = info.thread_offset[0] + info.local_shape[0]
    found = md5_search(end, info.scalars["target"],
                       device=views["found"].device).reshape(1)
    return {"found": torch.where(found == end, n, found)}


def phase_launch(sizes: Sizes, device: torch.device,
                 gen: torch.Generator) -> dict:
    """The annotated-kernel launch path: every body calls the port's public
    wrapper, every launch goes through the planner and ``Context.launch``."""
    t0 = time.perf_counter()
    on_card = device.type == "cuda"
    ctx = Context(device=device)
    out = {"phase": "launch"}

    def launched(wrapper_name: str, since: int, expect: int) -> int:
        n = WRAPPERS[wrapper_name].launches - since
        if on_card and n != expect:
            raise AssertionError(
                f"{wrapper_name}: {n} kernel launches, expected {expect}")
        return n

    # (a) the quickstart 1-D stencil, ten launches with buffer swap.
    stencil = KernelDef.define(
        "stencil", halo_stencil_body,
        "global i => read input[i-1:i+1], write output[i]")
    n = sizes.stencil_n
    t1 = time.perf_counter()
    x0 = torch.rand((n,), generator=gen, device=device)
    a = ctx.array(x0, dist=StencilDist(n // 8, 1), name="input")
    b = ctx.zeros((n,), dist=StencilDist(n // 8, 1), name="output")
    first = len(ctx.records)
    for _ in range(10):
        res = ctx.launch(stencil, grid=(n,), work_dist=BlockWork(n // 8),
                         args={"input": a, "output": b})
        a, b = res["output"], a
    ctx.synchronize(a)
    prefix = 1024  # ten steps of a prefix depend on ten more cells
    want = x0[: prefix + 10].cpu().numpy().astype(np.float32)
    for _ in range(10):
        pad = np.pad(want, 1)
        want = ((pad[:-2] + pad[1:-1] + pad[2:]) / np.float32(3.0)
                ).astype(np.float32)
    np.testing.assert_allclose(a.to_numpy()[:prefix], want[:prefix],
                               rtol=1e-5, atol=1e-6)
    require(len(ctx.records) - first == 10)
    comm = {k: v.value for k, v in ctx.records[-1].comm.items()}
    require(comm == {"input": "halo", "output": "local"}, comm)
    out["stencil"] = {"n": n, "launches": 10, "comm": comm,
                      "seconds": time.perf_counter() - t1}
    del x0, a, b, res

    # (b) HotSpot with a one-cell halo in both axes.
    hotspot = KernelDef.define(
        "hotspot", halo_hotspot_body,
        "global [i, j] => read temp[i-1:i+1, j-1:j+1], read power[i,j], "
        "write out[i,j]")
    rows, cols = sizes.hotspot
    t1 = time.perf_counter()
    temp0, power0 = hotspot_inputs((rows, cols), gen, device)
    slab = max(1, rows // 8)
    temp = ctx.array(temp0, dist=StencilDist(slab, 1), name="temp")
    power = ctx.array(power0, dist=BlockDist(slab), name="power")
    nxt = ctx.zeros((rows, cols), dist=StencilDist(slab, 1), name="out")
    since = hotspot_cuda.launches
    for _ in range(sizes.hotspot_steps):
        res = ctx.launch(hotspot, grid=(rows, cols),
                         work_dist=BlockWork(slab),
                         args={"temp": temp, "power": power, "out": nxt})
        temp, nxt = res["out"], temp  # swap, like the paper's host loop
    ctx.synchronize(temp)
    want = temp0
    for _ in range(sizes.hotspot_steps):
        want = hotspot_step_ref(want, power0)
    err = check_close("launch/hotspot", temp.value, want, rtol=2e-5,
                      atol=2e-4)
    require(ctx.records[-1].comm["temp"].value == "halo")
    out["hotspot"] = {
        "shape": [rows, cols], "steps": sizes.hotspot_steps,
        "kernel_launches": launched("hotspot", since, sizes.hotspot_steps),
        "max_abs_err": err[0], "seconds": time.perf_counter() - t1}
    del temp0, power0, temp, power, nxt, want, res

    # (c) K-Means with reduce(+) on sums and counts.
    kmeans = KernelDef.define(
        "kmeans", kmeans_body,
        "global i => read points[i,:], read centroids[:,:], "
        "reduce(+) sums[:,:], reduce(+) counts[:]")
    n = sizes.kmeans_n
    t1 = time.perf_counter()
    centers = lattice_centers(gen, device)
    pts = clustered_points(n, centers, gen)
    cen0 = start_centroids(centers, gen)
    points = ctx.array(pts, dist=RowDist(8), name="points")
    sums = ctx.zeros((KM_K, KM_F), dist=ReplicatedDist(), name="sums")
    counts = ctx.zeros((KM_K,), dist=ReplicatedDist(), name="counts")
    sample = pts[:: max(1, n // (1 << 20))]  # inertia on a stated subsample

    def inertia(c):
        d2 = torch.cdist(sample.double(), c.double()) ** 2
        return float(d2.min(dim=1).values.sum())

    since = kmeans_cuda.launches
    private_since = kmeans_cuda.routes["private"]
    cen, prev, trace = cen0, inertia(cen0), []
    for _ in range(sizes.kmeans_iters):
        res = ctx.launch(
            kmeans, grid=(n,), work_dist=BlockWork(max(1, n // 8)),
            args={"points": points,
                  "centroids": ctx.array(cen, name="centroids"),
                  "sums": sums, "counts": counts})
        cnt = res["counts"].value
        require(float(cnt.double().sum()) == float(n),
                "counts must sum to n")
        cen = res["sums"].value / cnt.clamp(min=1.0)[:, None]
        cur = inertia(cen)
        require(cur <= prev * 1.001, "inertia rose", prev, cur)
        prev = cur
        trace.append(cur)
    ctx.synchronize()
    comm = {k: v.value for k, v in ctx.records[-1].comm.items()}
    require(comm["sums"] == "reduce" and comm["counts"] == "reduce", comm)
    n_launched = launched("kmeans", since, sizes.kmeans_iters)
    by_private = kmeans_cuda.routes["private"] - private_since
    if on_card:
        require(by_private == n_launched, "kmeans took route private",
                by_private, "of", n_launched, "times")
    want = cen0
    for _ in range(sizes.kmeans_iters):
        s, c = kmeans_assign_reduce_ref(pts, want)
        want = s / c.clamp(min=1.0)[:, None]
    require(torch.equal(c, cnt), "final counts differ from the plain version")
    err = check_close("launch/kmeans", cen, want, rtol=1e-4, atol=1e-3)
    out["kmeans"] = {
        "n": n, "f": KM_F, "k": KM_K, "iterations": sizes.kmeans_iters,
        "kernel_launches": n_launched, "by_route_private": by_private,
        "inertia_on_sample": trace,
        "max_abs_err": err[0], "seconds": time.perf_counter() - t1}
    del pts, points, sample, res, want, s, c, cnt, cen

    # (d) co-clustering cluster sums with reduce(+).
    def csums_body(v, info):
        return {"cc": cluster_sums(v["z"], v["row_assign"], v["col_assign"],
                                   CS_R, CS_C)}

    csums = KernelDef.define(
        "cluster_sums", csums_body,
        "global [i, j] => read z[i,j], read row_assign[i], "
        "read col_assign[j], reduce(+) cc[:,:]")
    n, m = sizes.csums
    t1 = time.perf_counter()
    z, ra, ca = csums_inputs((n, m), gen, device)
    since = cluster_sums_cuda.launches
    res = ctx.launch(
        csums, grid=(n, m),
        args={"z": ctx.array(z, dist=RowDist(8), name="z"),
              "row_assign": ctx.array(ra, dist=RowDist(8), name="row_assign"),
              "col_assign": ctx.array(ca, name="col_assign"),
              "cc": ctx.zeros((CS_R, CS_C), name="cc")})
    ctx.synchronize()
    require(ctx.records[-1].comm["cc"].value == "reduce")
    want = cluster_sums_ref(z, ra, ca, CS_R, CS_C)
    err = check_close("launch/cluster_sums", res["cc"].value, want,
                      rtol=1e-4, atol=1e-3)
    mass = float(res["cc"].value.double().sum())
    total = float(z.double().sum())
    require(abs(mass - total) <= 1e-4 * total, mass, total)
    out["cluster_sums"] = {
        "shape": [n, m], "R": CS_R, "C": CS_C,
        "kernel_launches": launched("cluster_sums", since, 1),
        "max_abs_err": err[0], "seconds": time.perf_counter() - t1}
    del z, ra, ca, res, want

    # (e) GEMM, f32 and bf16.
    gemm_def = KernelDef.define(
        "gemm", lambda v, info: {"C": gemm(v["A"], v["B"])},
        "global [i, j] => read A[i,:], read B[:,j], write C[i,j]")
    g = sizes.gemm
    for tag, dtype, route in (("gemm", torch.float32, "pipe"),
                              ("gemm_bf16", torch.bfloat16, "wgmma")):
        t1 = time.perf_counter()
        a, b = gemm_inputs(g, g, g, dtype, gen, device)
        since = gemm_cuda.launches
        routes = dict(gemm_cuda.routes)
        res = ctx.launch(
            gemm_def, grid=(g, g),
            args={"A": ctx.array(a, dist=RowDist(), name="A"),
                  "B": ctx.array(b, dist=RowDist(), name="B"),
                  "C": ctx.zeros((g, g), dtype=dtype, dist=RowDist(),
                                 name="C")})
        ctx.synchronize()
        err = gemm_check(f"launch/{tag}", res["C"].value, gemm_ref(a, b), a,
                         b)
        taken = gemm_cuda.routes[route] - routes[route]
        require(taken == 1 or not on_card, tag, "took route", route, taken,
                "times:", gemm_cuda.routes, "before", routes)
        out[tag] = {"shape": [g, g, g], "dtype": str(dtype),
                    "kernel_launches": launched("gemm", since, 1),
                    "kernel_route": route, "max_abs_err": err[0],
                    **(err[2] if len(err) > 2 else {}),
                    "seconds": time.perf_counter() - t1}
        del a, b, res

    def comm_of_last() -> dict:
        return {k: v.value for k, v in ctx.records[-1].comm.items()}

    # (f) Black-Scholes, every argument block-distributed.
    def bs_body(v, info):
        call, put = black_scholes(v["price"], v["strike"], v["years"])
        return {"call": call, "put": put}

    bs_def = KernelDef.define(
        "black_scholes", bs_body,
        "global i => read price[i], read strike[i], read years[i], "
        "write call[i], write put[i]")
    n = sizes.bs_n
    t1 = time.perf_counter()
    price, strike, years = bs_inputs(n, gen, device)
    dist = BlockDist(n // 8)
    since = black_scholes_cuda.launches
    res = ctx.launch(
        bs_def, grid=(n,), work_dist=BlockWork(n // 8),
        args={"price": ctx.array(price, dist=dist, name="price"),
              "strike": ctx.array(strike, dist=dist, name="strike"),
              "years": ctx.array(years, dist=dist, name="years"),
              "call": ctx.zeros((n,), dist=dist, name="call"),
              "put": ctx.zeros((n,), dist=dist, name="put")})
    ctx.synchronize()
    comm = comm_of_last()
    require(comm == dict.fromkeys(
        ("price", "strike", "years", "call", "put"), "local"), comm)
    err = bs_check("launch/black_scholes",
                   (res["call"].value, res["put"].value),
                   black_scholes_ref(price, strike, years),
                   price, strike, years)
    out["black_scholes"] = {
        "n": n, "comm": comm,
        "kernel_launches": launched("black_scholes", since, 1),
        "max_abs_err": err[0], "seconds": time.perf_counter() - t1}
    del price, strike, years, res

    # (g) SpMV: rows distributed, the whole of x replicated (the paper's
    # over-estimate of an unstructured read).
    spmv_def = KernelDef.define(
        "spmv_ell",
        lambda v, info: {"y": spmv_ell(v["data"], v["cols"], v["x"])},
        "global i => read data[i,:], read cols[i,:], read x[:], write y[i]")
    rows, nnz = sizes.spmv
    t1 = time.perf_counter()
    data, cols, x = spmv_inputs(rows, nnz, rows, gen, device)
    since = spmv_ell_cuda.launches
    bin_since = spmv_ell_cuda.routes["bin"]
    res = ctx.launch(
        spmv_def, grid=(rows,), work_dist=BlockWork(rows // 8),
        args={"data": ctx.array(data, dist=RowDist(8), name="data"),
              "cols": ctx.array(cols, dist=RowDist(8), name="cols"),
              "x": ctx.array(x, name="x"),
              "y": ctx.zeros((rows,), dist=RowDist(8), name="y")})
    ctx.synchronize()
    comm = comm_of_last()
    require(comm == {"data": "local", "cols": "local", "x": "replicated",
                     "y": "local"}, comm)
    err = check_close("launch/spmv_ell", res["y"].value,
                      spmv_ell_ref(data, cols, x), rtol=1e-5, atol=1e-6)
    by_bin = spmv_ell_cuda.routes["bin"] - bin_since
    if on_card:
        require(by_bin == 1, "spmv_ell took route bin", by_bin, "times, not 1")
    out["spmv_ell"] = {
        "rows": rows, "max_nnz": nnz, "n": rows, "comm": comm,
        "kernel_launches": launched("spmv_ell", since, 1),
        "by_route_bin": by_bin,
        "max_abs_err": err[0], "seconds": time.perf_counter() - t1}
    del data, cols, x, res

    # (h) MD5: reduce(min) over the matching keys, once with the target
    # planted near the end and once with no key matching.  On one device
    # the body searches the whole grid.
    md5_def = KernelDef.define("md5", md5_prefix_body,
                               "global i => reduce(min) found[:]",
                               scalars=("target",))
    n = sizes.md5_n
    t1 = time.perf_counter()
    since = md5_search_cuda.launches
    unwind_since = md5_search_cuda.routes["unwind"]
    answers = []
    for target, expect in ((md5_digest(n - MD5_PLANT_BELOW_N),
                            n - MD5_PLANT_BELOW_N), (MD5_NO_MATCH, n)):
        res = ctx.launch(
            md5_def, grid=(n,), work_dist=BlockWork(n // 8),
            scalars={"target": target},
            args={"found": ctx.full((1,), n, dtype=torch.int32,
                                    name="found")})
        answers.append(int(res["found"].value[0]))
        require(answers[-1] == expect, "launch/md5", answers[-1], expect)
    comm = comm_of_last()
    require(comm == {"found": "reduce"}, comm)
    by_unwind = md5_search_cuda.routes["unwind"] - unwind_since
    if on_card:
        require(by_unwind == 2, "md5 took route unwind", by_unwind,
                "times, not 2")
    out["md5"] = {"n": n, "answers": answers, "comm": comm,
                  "kernel_launches": launched("md5", since, 2),
                  "by_route_unwind": by_unwind,
                  "seconds": time.perf_counter() - t1}

    # (i) N-Body: all bodies replicated, accelerations by rows.
    nbody_def = KernelDef.define(
        "nbody", lambda v, info: {"acc": nbody_forces(v["posm"])},
        "global i => read posm[:,:], write acc[i,:]")
    n, s = sizes.nbody_n, sizes.nbody_slab
    t1 = time.perf_counter()
    posm, _ = nbody_inputs(n, gen, device)
    since = nbody_cuda.launches
    tile_since = nbody_cuda.routes["tile"]
    res = ctx.launch(
        nbody_def, grid=(n,), work_dist=BlockWork(n // 8),
        args={"posm": ctx.array(posm, name="posm"),
              "acc": ctx.zeros((n, 3), dist=RowDist(8), name="acc")})
    ctx.synchronize()
    comm = comm_of_last()
    require(comm == {"posm": "replicated", "acc": "local"}, comm)
    err = nbody_slab_check("launch/nbody", res["acc"].value[:s],
                           nbody_forces_ref(posm, rows=(0, s)), posm, 0, s)
    by_tile = nbody_cuda.routes["tile"] - tile_since
    if on_card:
        require(by_tile == 1, "nbody took route tile", by_tile, "times")
    out["nbody"] = {
        "n": n, "checked_targets": s, "comm": comm,
        "kernel_launches": launched("nbody", since, 1),
        "by_route_tile": by_tile,
        "max_abs_err": err[0], "seconds": time.perf_counter() - t1}
    del posm, res

    # (j) the correlator: channels distributed, each superblock correlates
    # its own (the paper distributes channels across GPUs).
    corr_def = KernelDef.define(
        "correlate", lambda v, info: {"vis": correlate(v["samples"])},
        "global c => read samples[c,:,:,:], write vis[c,:,:,:]")
    c, t, a = sizes.corr
    t1 = time.perf_counter()
    (samples,) = corr_inputs(c, t, a, gen, device)
    since = correlate_cuda.launches
    tri_since = correlate_cuda.routes["tri"]
    res = ctx.launch(
        corr_def, grid=(c,), work_dist=BlockWork(max(1, c // 8)),
        args={"samples": ctx.array(samples, dist=RowDist(8), name="samples"),
              "vis": ctx.zeros((c, a, a, 2), dist=RowDist(8), name="vis")})
    ctx.synchronize()
    comm = comm_of_last()
    require(comm == {"samples": "local", "vis": "local"}, comm)
    err = corr_check("launch/correlate", res["vis"].value,
                     correlate_ref(samples), samples)
    launches = launched("correlate", since, 1)
    tri = correlate_cuda.routes["tri"] - tri_since
    if on_card:
        require(tri == launches, "launch/correlate: route tri took", tri,
                "of", launches, "launches")
    out["correlate"] = {
        "shape": [c, t, a], "comm": comm,
        "kernel_launches": launches, "route_tri_launches": tri,
        "max_abs_err": err[0], "seconds": time.perf_counter() - t1}
    del samples, res

    out["launch_records"] = len(ctx.records)
    out["launch_count_metric"] = ctx.registry.snapshot()
    # The mesh pass: five of the applications over MESH_WORKERS workers.
    out["mesh"] = mesh_pass(sizes, device, gen)
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    return out


def mesh_pass(sizes: Sizes, device: torch.device,
              gen: torch.Generator) -> dict:
    """The launch phase's applications over ``MESH_WORKERS`` workers on the
    one device (``Context(num_workers=...)``), each held against the same
    application over one worker on the same inputs in this run: the
    stencil and HotSpot (HALO) bit-equal, K-Means (REDUCE +) with equal
    counts and sums within rtol 1e-4 atol 1e-3, the f32 GEMM (B by GATHER)
    bit-equal, MD5 (REDUCE min) the same index and n with no match.  Each
    wrapper's counter must rise ``MESH_WORKERS`` times per launch (each
    worker's body calls it), by the route the one-worker run takes; the
    seconds of both runs (synchronized) are what the split costs on one
    card in halo copies, gathers and launches."""
    on_card = device.type == "cuda"
    w = MESH_WORKERS
    ctxs = {1: Context(device=device),
            w: Context(device=device, num_workers=w)}
    out = {"workers": w}

    def both(tag, inputs, run, compare, wrapper=None, route=None,
             launches=0):
        results, seconds, counts = {}, {}, {}
        for k, ctx in ctxs.items():
            wr = WRAPPERS.get(wrapper)
            before = (wr.launches, dict(getattr(wr, "routes", {}))) \
                if wr else (0, {})
            sync(device)
            t1 = time.perf_counter()
            results[k] = run(ctx, *inputs)
            ctx.synchronize()
            seconds[k] = time.perf_counter() - t1
            if wr and on_card:
                n = wr.launches - before[0]
                require(n == k * launches, f"mesh/{tag}:", n, "launches of",
                        wrapper, "over", k, "workers, not", k * launches)
                if route:
                    by = wr.routes[route] - before[1][route]
                    require(by == n, f"mesh/{tag}:", by, "of", n,
                            "launches by route", route)
                counts[k] = n
        detail = compare(f"mesh/{tag}", results[1], results[w])
        rec = ctxs[w].records[-1]
        out[tag] = {"comm": {a: p.value for a, p in rec.comm.items()},
                    "in_specs": rec.in_specs, "out_specs": rec.out_specs,
                    "seconds_1_worker": seconds[1],
                    f"seconds_{w}_workers": seconds[w],
                    **({"kernel_launches": counts} if counts else {}),
                    **detail}

    def equal(name, one, many):
        require(torch.equal(one, many), name, "differs from one worker by",
                float((one.double() - many.double()).abs().max()))
        return {"bit_equal": True}

    # the stencil, ten launches with buffer swap
    stencil = KernelDef.define(
        "stencil", halo_stencil_body,
        "global i => read input[i-1:i+1], write output[i]")
    n = sizes.stencil_n

    def run_stencil(ctx, x0):
        dist = StencilDist(n // w, 1)
        a = ctx.array(x0, dist=dist, name="input")
        b = ctx.zeros((n,), dist=dist, name="output")
        for _ in range(10):
            res = ctx.launch(stencil, grid=(n,), work_dist=BlockWork(n // w),
                             args={"input": a, "output": b})
            a, b = res["output"], a
        return a.value

    both("stencil", (torch.rand((n,), generator=gen, device=device),),
         run_stencil, equal)

    # HotSpot, the launch phase's steps
    hotspot = KernelDef.define(
        "hotspot", halo_hotspot_body,
        "global [i, j] => read temp[i-1:i+1, j-1:j+1], read power[i,j], "
        "write out[i,j]")
    rows, cols = sizes.hotspot
    steps = sizes.hotspot_steps

    def run_hotspot(ctx, temp0, power0):
        slab = rows // w
        temp = ctx.array(temp0, dist=StencilDist(slab, 1), name="temp")
        power = ctx.array(power0, dist=BlockDist(slab), name="power")
        nxt = ctx.zeros((rows, cols), dist=StencilDist(slab, 1), name="out")
        for _ in range(steps):
            res = ctx.launch(hotspot, grid=(rows, cols),
                             work_dist=BlockWork(slab),
                             args={"temp": temp, "power": power, "out": nxt})
            temp, nxt = res["out"], temp
        return temp.value

    both("hotspot", hotspot_inputs((rows, cols), gen, device), run_hotspot,
         equal, "hotspot", None, steps)

    # K-Means, the launch phase's iterations, reduce(+)
    kmeans = KernelDef.define(
        "kmeans", kmeans_body,
        "global i => read points[i,:], read centroids[:,:], "
        "reduce(+) sums[:,:], reduce(+) counts[:]")
    n = sizes.kmeans_n

    def run_kmeans(ctx, pts, cen):
        points = ctx.array(pts, dist=RowDist(w), name="points")
        sums = ctx.zeros((KM_K, KM_F), dist=ReplicatedDist(), name="sums")
        counts = ctx.zeros((KM_K,), dist=ReplicatedDist(), name="counts")
        trace = []
        for _ in range(sizes.kmeans_iters):
            res = ctx.launch(
                kmeans, grid=(n,), work_dist=BlockWork(n // w),
                args={"points": points,
                      "centroids": ctx.array(cen, name="centroids"),
                      "sums": sums, "counts": counts})
            cnt, tot = res["counts"].value, res["sums"].value
            trace.append((cnt, tot))
            cen = tot / cnt.clamp(min=1.0)[:, None]
        return trace

    def kmeans_close(name, one, many):
        err = 0.0
        for it, ((c1, s1), (cw, sw)) in enumerate(zip(one, many)):
            require(torch.equal(c1, cw), name, "counts differ at iteration",
                    it)
            err = max(err, check_close(f"{name}/sums/{it}", sw, s1,
                                       rtol=1e-4, atol=1e-3)[0])
        return {"counts_equal": True, "sums_max_abs_err": err}

    centers = lattice_centers(gen, device)
    both("kmeans", (clustered_points(n, centers, gen),
                    start_centroids(centers, gen)), run_kmeans, kmeans_close,
         "kmeans", "private", sizes.kmeans_iters)

    # the f32 GEMM, B gathered
    gemm_def = KernelDef.define(
        "gemm", lambda v, info: {"C": gemm(v["A"], v["B"])},
        "global [i, j] => read A[i,:], read B[:,j], write C[i,j]")
    g = sizes.gemm

    def run_gemm(ctx, a, b):
        return ctx.launch(
            gemm_def, grid=(g, g),
            args={"A": ctx.array(a, dist=RowDist(), name="A"),
                  "B": ctx.array(b, dist=RowDist(), name="B"),
                  "C": ctx.zeros((g, g), dist=RowDist(), name="C")}
        )["C"].value

    both("gemm", gemm_inputs(g, g, g, torch.float32, gen, device), run_gemm,
         equal, "gemm", "pipe" if on_card else None, 1)

    # MD5, reduce(min): the planted key, then no match
    md5_def = KernelDef.define("md5", md5_prefix_body,
                               "global i => reduce(min) found[:]",
                               scalars=("target",))
    n = sizes.md5_n
    targets = ((md5_digest(n - MD5_PLANT_BELOW_N), n - MD5_PLANT_BELOW_N),
               (MD5_NO_MATCH, n))

    def run_md5(ctx):
        return [int(ctx.launch(
            md5_def, grid=(n,), work_dist=BlockWork(n // w),
            scalars={"target": t},
            args={"found": ctx.full((1,), n, dtype=torch.int32,
                                    name="found")})["found"].value[0])
            for t, _ in targets]

    def md5_same(name, one, many):
        want = [e for _, e in targets]
        require(one == many == want, name, "found", many, "one worker",
                one, "expected", want)
        return {"answers": many}

    both("md5", (), run_md5, md5_same, "md5", "unwind" if on_card else None,
         len(targets))
    return out


def host_points(n: int, centers: np.ndarray, seed: int) -> np.ndarray:
    """(n, f) clustered points in host memory, made cheaply: one seeded
    block of at most 2**20 rows, tiled, with a small offset per tile so
    that the tiles differ while every point stays within 0.5 + 0.064 of its
    lattice centre."""
    rng = np.random.RandomState(seed)
    block_rows = min(n, 1 << 20)
    which = rng.randint(0, centers.shape[0], block_rows)
    block = (centers[which] + rng.rand(block_rows, centers.shape[1]) - 0.5
             ).astype(np.float32)
    data = np.empty((n, centers.shape[1]), np.float32)
    for t, start in enumerate(range(0, n, block_rows)):
        rows = min(block_rows, n - start)
        np.add(block[:rows], np.float32(0.001 * (t % 64)),
               out=data[start:start + rows])
    return data


def overlap_share(intervals) -> float:
    """Share of the copies' time during which a kernel was running too."""
    copy_total = sum(ce - cs for cs, ce, _, _ in intervals)
    hidden = 0.0
    for cs, ce, _, _ in intervals:
        for _, _, ks, ke in intervals:
            hidden += max(0.0, min(ce, ke) - max(cs, ks))
    return hidden / copy_total if copy_total > 0 else 0.0


def phase_stream(sizes: Sizes, device: torch.device, seed: int) -> dict:
    """``stream_kmeans`` over host-resident points, against the same
    iterations computed chunk by chunk with the plain version."""
    t0 = time.perf_counter()
    on_card = device.type == "cuda"
    n, halved = sizes.stream_n, 0
    free = os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    while n * KM_F * 4 * 3 > free and n > sizes.stream_chunk_rows:
        n //= 2  # too little host memory for the data and its staging
        halved += 1
    gen = torch.Generator(device=device).manual_seed(seed)
    centers = lattice_centers(gen, device)
    cen0 = start_centroids(centers, gen)
    t_gen = time.perf_counter()
    pts = host_points(n, centers.cpu().numpy(), seed)
    t_gen = time.perf_counter() - t_gen
    chunk_bytes = sizes.stream_chunk_rows * KM_F * 4

    since = kmeans_cuda.launches
    private_since = kmeans_cuda.routes["private"]
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
    cen, per_iter, kernel_cens = cen0, [], []
    for _ in range(sizes.stream_iters):
        stats = {}
        t1 = time.perf_counter()
        cen = stream_kmeans(pts, cen, chunk_rows=sizes.stream_chunk_rows,
                            device=device, stats=stats)
        sync(device)
        dt = time.perf_counter() - t1
        it = {"seconds": dt, "GB_per_s": pts.nbytes / dt / 1e9,
              "chunks": stats["chunks"]}
        if on_card:
            iv = stats["intervals_ms"]
            it["copy_ms"] = sum(ce - cs for cs, ce, _, _ in iv)
            it["compute_ms"] = sum(ke - ks for _, _, ks, ke in iv)
            it["copy_hidden_share"] = overlap_share(iv)
        per_iter.append(it)
        kernel_cens.append(cen)
    n_chunks = -(-n // sizes.stream_chunk_rows)
    out = {"phase": "stream", "n": n, "f": KM_F, "k": KM_K,
           "bytes": int(pts.nbytes), "halved": halved,
           "chunk_rows": sizes.stream_chunk_rows, "chunk_bytes": chunk_bytes,
           "iterations": per_iter, "generate_seconds": t_gen}
    if on_card:
        peak = torch.cuda.max_memory_allocated(device) - base
        out["peak_device_bytes"] = peak
        # Two chunk buffers, the accumulator and the kernel's partials.
        require(peak <= 2 * chunk_bytes + (8 << 20),
                f"device working set {peak} exceeds two chunks")
        launched = kmeans_cuda.launches - since
        require(launched == sizes.stream_iters * n_chunks,
                f"{launched} kernel launches for {n_chunks} chunks")
        by_private = kmeans_cuda.routes["private"] - private_since
        require(by_private == launched, "kmeans took route private",
                by_private, "of", launched, "times")
        out["kernel_launches"] = launched
        out["by_route_private"] = by_private

    # The same iterations with the plain version, chunk by chunk.
    cen, worst = cen0, 0.0
    for got in kernel_cens:
        want = stream_kmeans(pts, cen, chunk_rows=sizes.stream_chunk_rows,
                             use_kernel=False, device=device)
        # rtol 2e-4 atol 2e-4, the reference's streaming tolerance: the
        # f32 accumulator sums the chunks' partials in another order.
        worst = max(worst, check_close("stream/kmeans", got, want,
                                       rtol=2e-4, atol=2e-4)[0])
        cen = got
    require(torch.isfinite(kernel_cens[-1]).all())
    require(kernel_cens[-1].shape == (KM_K, KM_F))
    out["max_abs_err"] = worst
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    return out


#: Tolerance of the serving path's bf16 logits, kernels against plain
#: versions, as a share of the largest logit: bf16 keeps 8 bits, each layer
#: rounds its kernels' outputs (and the plain path also its attention
#: logits and probabilities, or its scans' reads) at other places than the
#: kernels do, and these differences of ~2^-8 of a layer's output add up
#: through the residual stream; 5e-2 of the largest logit is some ten times
#: that estimate.  It checks the path as a whole, not the kernels: those
#: are held, call by call, to the bf16 limit of the kernels phase
#: (``layer_gaps``).
BF16_LOGIT_TOL = 5e-2
#: f32 at full width: the reference's test_prefill_decode_matches_full_forward.
F32_LOGIT_TOL = 2e-3

#: one model of each family the port serves, in the order the runs go
SERVE_ARCHS = ("phi3-mini-3.8b", "rwkv6-3b", "recurrentgemma-2b")
#: depth of the f32 check at full width: two layers, three for the hybrid,
#: whose two would be two recurrent blocks and no attention block, and six
#: for rwkv6-3b, the most at which its two f32 paths still agree (its
#: logits after each block, tools/depth_divergence.py: 3.6e-5 of the
#: largest logit after block 6, 6e-4 after block 8 and 18 % after 32)
F32_LAYERS = {"dense": 2, "rwkv": 6, "hybrid": 3}
#: With random weights rwkv6-3b amplifies rounding through depth, and the
#: reference's own two WKV paths do so too (tests/test_torch_recurrent.py,
#: test_rwkv_amplifies_rounding_through_depth): in bf16 its kernel and
#: plain paths' logits part by 1.6 % of the largest logit after one block,
#: 4.4 % after two and 62 % after 32 (tools/depth_divergence.py).  So its
#: full-depth bf16 logits are reported, each WKV6 call at full depth is
#: held to the bf16 limit, and its bf16 logits, the prefill then decode
#: among them, are gated at this depth
RWKV_LOGIT_LAYERS = 1


def serve_traffic(sizes: Sizes, vocab: int, seed: int,
                  n: int) -> list[Request]:
    """``n`` requests from ``seed``: prompt lengths heavy-tailed over
    ``serve_prompt`` (the shortest times 1 + Lomax(1.5): median about 1.6x
    the shortest, some at the longest), the first request at the longest;
    ``max_new_tokens`` uniform over ``serve_new``; greedy, except every
    fourth request at temperature 0.8."""
    rng = np.random.default_rng(seed)
    lo, hi = sizes.serve_prompt
    reqs = []
    for rid in range(n):
        plen = hi if rid == 0 else int(min(hi, lo * (1.0 + rng.pareto(1.5))))
        reqs.append(Request(
            rid=rid, prompt=rng.integers(0, vocab, plen).astype(np.int32),
            max_new_tokens=int(rng.integers(sizes.serve_new[0],
                                            sizes.serve_new[1] + 1)),
            temperature=0.8 if rid % 4 == 3 else 0.0))
    return reqs


@contextlib.contextmanager
def recorded(module, name: str, calls: list | None = None):
    """Every call of ``module.name`` inside the block, as (arguments,
    keyword arguments, result), in the list it yields: ``calls`` where
    given (so that several functions record into one list in the order of
    their calls), else a new one."""
    fn = getattr(module, name)
    calls = [] if calls is None else calls

    def spy(*args, **kw):
        result = fn(*args, **kw)
        calls.append((args, kw, result))
        return result

    setattr(module, name, spy)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


@dataclasses.dataclass(frozen=True)
class Spy:
    """A kernel's calls in a model pass, held call by call against its
    plain version: ``module.name`` is what the model calls, ``plain`` is
    called on f32 copies of the same arguments, ``calls`` is how many a pass
    makes.  A second result is an lse (held to ``BF16_LSE_ATOL`` in bf16)
    or a final state (held to the bf16 limit); ``tol`` is the f32 tolerance
    of the output and of the second result."""
    module: object
    name: str
    plain: object
    calls: int
    second: str = "lse"
    tol: tuple = ATTN_TOL[torch.float32]


def serve_spec(cfg, sizes: Sizes) -> dict:
    """What a family's serving run checks and counts: the kernel calls of
    a prefill and of a decode step, the depth at which the bf16 logits are
    gated (None: the full depth), the check prompt's length, the kernels a
    decode step and a prefill are profiled for, the launches an engine run
    of ``prefills`` and ``steps`` makes and, for a kernel whose route
    depends on the prompt, its launches by route (``expect_routes``, from
    the prompt lengths and the steps)."""
    if cfg.family == "rwkv":
        wkv = Spy(model_rwkv, "wkv6", wkv6_ref, cfg.n_layers, "state",
                  (SCAN_TOL, SCAN_TOL))

        def wkv_routes(prompt_lens, steps):
            # each prefill by the route its length gives, each decode step
            # (T = 1) by "fma"
            chunked = sum(wkv6_route(torch.empty((1, 1, n, 1), device="meta"),
                                     None) == "chunk" for n in prompt_lens)
            return {"wkv6": {
                "chunk": cfg.n_layers * chunked,
                "fma": cfg.n_layers * (len(prompt_lens) - chunked + steps)}}
        return {"prefill": [wkv], "decode": [wkv],
                "logit_layers": RWKV_LOGIT_LAYERS,
                "check_len": sizes.serve_check_len,
                "profile": {"decode_step": ("wkv6_kernel",),
                            "prefill": ("wkv6_deltas_kernel",
                                        "wkv6_carry_kernel",
                                        "wkv6_outputs_kernel")},
                "expect": lambda prefills, steps: {
                    "wkv6": cfg.n_layers * (prefills + steps)},
                "expect_routes": wkv_routes}
    if cfg.family == "hybrid":
        groups, tail = model_rglru.n_groups(cfg)
        rec = 2 * groups + tail
        lru = Spy(model_rglru, "rg_lru", lambda *a, **kw: rg_lru(
            *a, use_ref=True, **kw), rec, "state", (SCAN_TOL, SCAN_TOL))

        def lru_routes(prompt_lens, steps):
            # each prefill by the route its length gives, each decode step
            # (T = 1) by "fma"
            chunked = sum(rg_lru_route(torch.empty((1, n, 1), device="meta"))
                          == "chunk" for n in prompt_lens)
            return {"rg_lru": {
                "chunk": rec * chunked,
                "fma": rec * (len(prompt_lens) - chunked + steps)}}
        return {"prefill": [lru, Spy(model_attention, "flash_attention",
                                     attention_ref, groups)],
                "decode": [lru, Spy(model_attention, "cuda_decode",
                                    decode_attention_ref, groups)],
                "logit_layers": None,
                "check_len": sizes.serve_check_len_window,
                "profile": {"decode_step": ("rg_lru_kernel",
                                            "decode_mma_kernel",
                                            "decode_mma_combine_kernel"),
                            "prefill": ("flash_wgmma_kernel",
                                        "rg_lru_local_kernel",
                                        "rg_lru_outputs_kernel")},
                "expect": lambda prefills, steps: {
                    "rg_lru": rec * (prefills + steps),
                    "flash_attention": groups * prefills,
                    "decode_attention": groups * steps},
                "expect_routes": lru_routes}
    return {"prefill": [Spy(model_attention, "flash_attention", attention_ref,
                            cfg.n_layers)],
            "decode": [Spy(model_attention, "cuda_decode",
                           decode_attention_ref, cfg.n_layers)],
            "logit_layers": None, "check_len": sizes.serve_check_len,
            "profile": {"decode_step": ("decode_mma_kernel",
                                        "decode_mma_combine_kernel"),
                        "prefill": ("flash_wgmma_kernel",)},
            "expect": lambda prefills, steps: {
                "flash_attention": cfg.n_layers * prefills,
                "decode_attention": cfg.n_layers * steps}}


def layer_gaps(what: str, calls, spy: Spy) -> dict:
    """Each call of ``spy``'s kernel in a model pass held against the plain
    version on f32 copies of its own inputs: bf16 within the bf16 limit of
    the kernels phase, f32 within ``spy.tol``.  Returns the worst over the
    calls."""
    require(len(calls) == spy.calls, what, len(calls), spy.name,
            "calls, expected", spy.calls)
    worst = {"calls": len(calls), "max_abs_err": 0.0}
    for i, (args, kw, got) in enumerate(calls):
        want = spy.plain(*as_f32(args), **kw)
        out, second = got if isinstance(got, tuple) else (got, None)
        want_out, want_second = want if isinstance(want, tuple) \
            else (want, None)
        name = f"serve/{what} {spy.name} call {i}"
        if out.dtype == torch.bfloat16:
            if spy.second == "state":
                gap = bf16_check(name, out, want_out)
                share = max(gap["limit_share"], bf16_check(
                    f"{name}/state", second, want_second)["limit_share"])
            else:
                gap = bf16_check(name, out, want_out, second, want_second)
                share = max(gap["limit_share"],
                            gap.get("lse_limit_share", 0.0))
            err = gap["max_abs_err"]
            worst["limit_share"] = max(worst.get("limit_share", 0.0), share)
        else:
            tol, tol2 = spy.tol
            err = check_close(name, out, want_out, rtol=tol, atol=tol)[0]
            if second is not None:
                check_close(f"{name}/{spy.second}", second, want_second,
                            rtol=tol2, atol=tol2)
        worst["max_abs_err"] = max(worst["max_abs_err"], err)
    return worst


def logits_gap(got: torch.Tensor, want: torch.Tensor) -> dict:
    """Largest difference over the largest logit, in float64, and the share
    of positions whose top token agrees; a slab of positions at a time (a
    hybrid's 2600 positions over 256,000 tokens are 2.7 GB in f32)."""
    vocab = want.shape[-1]
    g2, w2 = got.reshape(-1, vocab), want.reshape(-1, vocab)
    rows = max(1, CHECK_SLAB // 4 // vocab)
    diff = logit = 0.0
    agree = 0
    for lo in range(0, w2.shape[0], rows):
        g, w = g2[lo:lo + rows].double(), w2[lo:lo + rows].double()
        require(torch.isfinite(g).all(), "logits have non-finite values")
        diff = max(diff, float((g - w).abs().max()))
        logit = max(logit, float(w.abs().max()))
        agree += int((g.argmax(-1) == w.argmax(-1)).sum())
    return {"max_abs_diff": diff, "max_abs_logit": logit,
            "rel_to_max": diff / logit, "argmax_agree": agree / w2.shape[0]}


@contextlib.contextmanager
def spying(spies: list[Spy]):
    """``recorded`` for each of ``spies``; yields their lists of calls."""
    with contextlib.ExitStack() as stack:
        yield [stack.enter_context(recorded(spy.module, spy.name))
               for spy in spies]


@torch.no_grad()
def serve_check(params, cfg, sizes: Sizes, device, gen, max_len,
                gate_logits: bool = True) -> dict:
    """With the kernels (attention_impl "cuda") against the plain path
    ("naive": the materialized attention and the scans' plain versions) on
    the same weights and the same state: (a) one prefill of the check
    prompt and one decode step of all slots, their prompts spread over
    [1, the check prompt] and each prefilled and spliced in as the engine
    does; every kernel call against its plain version on f32 copies of its
    own inputs (``layer_gaps``), and the logits; (b) a prefill of all but
    the last three tokens of the check prompt and three decode steps,
    against (a)'s prefill logits of those positions.  Logits within
    ``BF16_LOGIT_TOL`` of the largest logit in bf16 and ``F32_LOGIT_TOL``
    element-wise in f32; with ``gate_logits`` False (a model too deep for
    its logits to judge the kernels, ``RWKV_LOGIT_LAYERS``) the bf16
    logits are reported, and every kernel call is still held."""
    plain = cfg.scaled(attention_impl="naive")
    spec = serve_spec(cfg, sizes)
    f32 = cfg.torch_dtype == torch.float32
    n, slots = spec["check_len"], sizes.serve_slots
    max_len = max(max_len, n + 1)
    toks = torch.randint(0, cfg.vocab, (1, n), generator=gen, device=device,
                         dtype=torch.int32)
    out = {"prefill_tokens": n}
    logits = []
    for c in (cfg, plain):
        state = model_api.init_decode_state(c, 1, max_len, device)
        with spying(spec["prefill"]) as calls:
            logits.append(model_api.forward(params, toks, c, mode="prefill",
                                            state=state)[0])
        if c is cfg:
            for spy, got in zip(spec["prefill"], calls):
                out[f"prefill_{spy.name}"] = layer_gaps("prefill", got, spy)
        del calls, state
    out["prefill"] = logits_gap(*logits)
    lengths = np.linspace(1, n, slots).astype(int)
    prompts = [torch.randint(0, cfg.vocab, (int(m),), generator=gen,
                             device=device, dtype=torch.int32)
               for m in lengths]
    state = model_api.init_decode_state(cfg, slots, max_len, device)
    for i, p in enumerate(prompts):
        one = model_api.init_decode_state(cfg, 1, max_len, device)
        state = _splice_state(
            state, model_api.prefill(params, {"tokens": p[None]}, cfg, one)[1],
            i)
    step = torch.randint(0, cfg.vocab, (slots, 1), generator=gen,
                         device=device, dtype=torch.int32)
    # A dense model's call writes its own k/v at ``pos`` before reading the
    # cache, and a hybrid's its own ring slot; the recurrent state is not
    # written: both calls read the same prefix.
    with spying(spec["decode"]) as calls:
        dec = [model_api.decode_step(params, step, cfg, state)[0]]
    for spy, got in zip(spec["decode"], calls):
        out[f"decode_{spy.name}"] = layer_gaps("decode", got, spy)
    del calls
    dec.append(model_api.decode_step(params, step, plain, state)[0])
    out["decode"] = dict(logits_gap(*dec), kv_len=(lengths + 1).tolist())
    one = model_api.init_decode_state(cfg, 1, max_len, device)
    _, one = model_api.prefill(params, {"tokens": toks[:, :n - 3]}, cfg, one)
    stepped = []
    for i in range(n - 3, n):
        lg, one = model_api.decode_step(params, toks[:, i:i + 1], cfg, one)
        stepped.append(lg[:, -1])
    stepped, full = torch.stack(stepped, dim=1), logits[0][:, n - 3:]
    out["prefill_then_decode"] = logits_gap(stepped, full)
    if f32:
        for what, got, want in (("prefill", *logits), ("decode", *dec),
                                ("prefill then decode", stepped, full)):
            check_close(f"serve/f32 {what}", got, want, rtol=F32_LOGIT_TOL,
                        atol=F32_LOGIT_TOL)
    elif gate_logits:
        for what in ("prefill", "decode", "prefill_then_decode"):
            require(out[what]["rel_to_max"] <= BF16_LOGIT_TOL, "serve/bf16",
                    what, out[what])
    out["logits_gated"] = f32 or gate_logits
    out["state"] = state  # for the profile, dropped before printing
    out["step"] = step
    return out


def device_us(evt) -> float:
    t = getattr(evt, "device_time_total", None)
    return t if t is not None else getattr(evt, "cuda_time_total", 0.0)


def kernel_device_ms(prof, *names) -> float | None:
    """Device ms of the kernels whose names hold one of ``names``, from
    ``torch.profiler``; None where the profiler saw none."""
    total = sum(device_us(evt) for evt in prof.key_averages()
                if any(n in evt.key for n in names))
    return total / 1e3 if total > 0 else None


def device_breakdown(prof, calls: int, top: int = 8) -> dict:
    """All device time the profiler saw, per call, and its ``top`` largest
    kernels by name: where a step's device time goes."""
    rows = sorted(((device_us(e), e.count, e.key)
                   for e in prof.key_averages() if device_us(e) > 0),
                  reverse=True)
    return {"device_ms": sum(r[0] for r in rows) / 1e3 / calls,
            "top": [{"kernel": key[:100], "ms": us / 1e3 / calls,
                     "launches": n / calls} for us, n, key in rows[:top]]}


@torch.no_grad()
def serve_profile(params, cfg, sizes: Sizes, device, state, step,
                  toks) -> dict:
    """The ported kernels' share of a decode step of all slots and of a
    prefill of the check prompt: CUDA-event times of the step (the
    host's issue time included), the device time of all kernels and of the
    ported ones from ``torch.profiler`` over the same calls, the largest
    kernels, and where a call waits for the device."""
    n = sizes.profile_steps
    calls = {
        "decode_step": lambda: model_api.decode_step(params, step, cfg,
                                                     state),
        "prefill": lambda: model_api.prefill(
            params, {"tokens": toks}, cfg,
            model_api.init_decode_state(cfg, 1, toks.shape[1], device)),
    }
    out = {}
    for what, kernels in serve_spec(cfg, sizes)["profile"].items():
        fn = calls[what]
        out[f"{what}_ms"] = time_ms(fn, device, n)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            sync(device)
        out[f"{what}_kernels"] = device_breakdown(prof, n)
        ported_ms = kernel_device_ms(prof, *kernels)
        if ported_ms is not None:
            ported_ms /= n
            out[f"{what}_ported"] = list(kernels)
            out[f"{what}_ported_ms_by_kernel"] = {
                k: (kernel_device_ms(prof, k) or 0.0) / n for k in kernels}
            out[f"{what}_ported_ms"] = ported_ms
            out[f"{what}_ported_share"] = ported_ms / out[f"{what}_ms"]
            out[f"{what}_ported_device_share"] = \
                ported_ms / out[f"{what}_kernels"]["device_ms"]
        out[f"{what}_syncs"] = sync_points(fn)
    return out


def sync_points(fn) -> dict:
    """Where one call waits for the device, by PyTorch's sync debug mode:
    the number of synchronizing operations (it warns at each), and the
    innermost Python frames of the first (it raises there)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    count = sum("synchroniz" in str(w.message) for w in caught)
    first = None
    if count:
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn()
        except RuntimeError as e:
            first = [f"{os.path.relpath(f.filename)}:{f.lineno} {f.name}"
                     for f in traceback.extract_tb(e.__traceback__)][-8:]
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return {"count": count, "first": first}


def pct(values, q) -> float:
    return float(np.percentile(np.asarray(values, np.float64), q))


def phase_serve(sizes: Sizes, device: torch.device, seed: int,
                arch: str) -> dict:
    """LM serving with ``arch`` at full width and depth in bf16: the bf16
    check at full depth, the f32 check at ``F32_LAYERS`` and, for a family
    whose full-depth logits are not gated, the bf16 check at its
    ``logit_layers`` (``serve_check``), the ported kernels' share of a step,
    then ``ServeEngine`` over the
    seeded traffic with every launch counter set to 0 just before and read
    just after."""
    t0 = time.perf_counter()
    on_card = device.type == "cuda"
    cfg = get_smoke_config(arch) if sizes.serve_smoke else get_config(arch)
    require(cfg.attention_impl == "cuda", cfg.attention_impl)
    spec = serve_spec(cfg, sizes)
    max_len = sizes.serve_prompt[1] + sizes.serve_new[1] + 8
    gen = torch.Generator(device=device).manual_seed(seed)
    t1 = time.perf_counter()
    params = model_api.init_params(gen, cfg, device)
    sync(device)
    out = {"phase": "serve", "arch": cfg.name, "family": cfg.family,
           "dtype": cfg.dtype, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "n_heads": cfg.n_heads,
           "n_kv_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim,
           "d_ff": cfg.d_ff, "vocab": cfg.vocab,
           **({"wkv_head_dim": cfg.wkv_head_dim} if cfg.family == "rwkv"
              else {}),
           **({"window": cfg.window, "groups_and_tail":
               model_rglru.n_groups(cfg)} if cfg.family == "hybrid" else {}),
           "params": model_api.param_count(params),
           "param_bytes": sum(p.numel() * p.element_size()
                              for p in params.parameters()),
           "init_seconds": time.perf_counter() - t1}

    t1 = time.perf_counter()
    routes_before = route_counts()
    check = serve_check(params, cfg, sizes, device, gen, max_len,
                        gate_logits=spec["logit_layers"] is None)
    state, step = check.pop("state"), check.pop("step")
    # Every bf16 attention call of the check took the tensor cores.
    for name in ("flash_attention", "decode_attention"):
        check[f"{name}_routes"] = {
            r: n - routes_before[name][r]
            for r, n in WRAPPERS[name].routes.items()}
        require(check[f"{name}_routes"]["fma"] == 0, "bf16", name,
                "took route fma:", check[f"{name}_routes"])
    out["check"] = dict(check, seconds=time.perf_counter() - t1)
    if on_card:
        toks = torch.randint(0, cfg.vocab, (1, sizes.serve_check_len),
                             generator=gen, device=device, dtype=torch.int32)
        t1 = time.perf_counter()
        out["profile"] = serve_profile(params, cfg, sizes, device, state,
                                       step, toks)
        out["profile"]["seconds"] = time.perf_counter() - t1
    del state, step

    cuts = {"check_f32": cfg.scaled(n_layers=F32_LAYERS[cfg.family],
                                    dtype="float32")}
    if spec["logit_layers"] is not None:
        cuts["check_bf16_cut"] = cfg.scaled(n_layers=spec["logit_layers"])
    for key, cut in cuts.items():
        t1 = time.perf_counter()
        cut_params = model_api.init_params(gen, cut, device)
        checked = serve_check(cut_params, cut, sizes, device, gen, max_len)
        for drop in ("state", "step"):
            checked.pop(drop)
        out[key] = dict(checked, n_layers=cut.n_layers,
                        seconds=time.perf_counter() - t1)
        del cut_params
        if on_card:
            torch.cuda.empty_cache()

    t1 = time.perf_counter()
    reqs = serve_traffic(sizes, cfg.vocab, seed,
                         sizes.serve_requests if cfg.family == "dense"
                         else sizes.serve_requests_recurrent)
    tracer = Tracer(clock=time.perf_counter)
    engine = ServeEngine(params, cfg, slots=sizes.serve_slots,
                         max_len=max_len, seed=seed, tracer=tracer,
                         device=device)
    out["engine_setup_seconds"] = time.perf_counter() - t1
    # The serving path: every count set to 0 just before, read just after.
    zero_counts()
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    submitted = {}
    t1 = time.perf_counter()
    for r in reqs:
        submitted[r.rid] = time.perf_counter()
        engine.submit(r)
    done = engine.run(max_steps=100_000)
    sync(device)
    wall = time.perf_counter() - t1
    counts = {name: w.launches for name, w in WRAPPERS.items()}
    routes = route_counts()

    require(len(done) == len(reqs), "completed", len(done), "of", len(reqs))
    bad = [(r.rid, r.status, len(r.output), r.max_new_tokens) for r in done
           if r.status != "ok" or len(r.output) != r.max_new_tokens]
    require(not bad, "requests not ok:", bad)
    prefills = [e for e in tracer.events if e["name"].startswith("prefill:")]
    steps = [e["dur"] * 1e3 for e in tracer.events
             if e["name"] == "decode_step"]
    ttft = [(e["ts"] + e["dur"] - submitted[e["args"]["rid"]]) * 1e3
            for e in prefills]
    n_steps = engine.stats["steps"]
    require(len(prefills) == len(reqs) and len(steps) == n_steps)
    expect = spec["expect"](len(prefills), n_steps)
    if on_card:
        for name, n in counts.items():
            require(n == expect.get(name, 0), name, "launched", n,
                    "times in the engine run, expected", expect.get(name, 0))
        require(routes["flash_attention"]["wgmma"]
                == counts["flash_attention"], "flash attention routes in "
                "the engine run:", routes["flash_attention"])
        require(routes["decode_attention"]["mma"]
                == counts["decode_attention"], "decode attention routes in "
                "the engine run:", routes["decode_attention"])
    prompt_lens = [e["args"]["prompt_len"] for e in prefills]
    expect_routes = spec.get("expect_routes", lambda *a: {})(prompt_lens,
                                                             n_steps)
    if on_card:
        for name, want in expect_routes.items():
            require(routes[name] == want, name, "routes in the engine run",
                    routes[name], "expected", want)
    tokens = engine.stats["prefill_tokens"] + engine.stats["decode_tokens"]
    out.update({
        "slots": sizes.serve_slots, "max_len": max_len,
        "requests": len(reqs), "completed_ok": len(done),
        "prompt_lengths": sorted(len(r.prompt) for r in reqs),
        "prefill_tokens": engine.stats["prefill_tokens"],
        "decode_tokens": engine.stats["decode_tokens"],
        "decode_steps": n_steps, "retries": engine.stats["retries"],
        "ttft_ms": {"p50": pct(ttft, 50), "p90": pct(ttft, 90),
                    "max": max(ttft)},
        "decode_step_ms": {"p50": pct(steps, 50), "p90": pct(steps, 90)},
        "prefill_ms_by_len": [[n, ms] for n, ms in sorted(
            (e["args"]["prompt_len"], e["dur"] * 1e3) for e in prefills)],
        "engine_seconds": wall,
        "tokens_per_s": tokens / wall,
        "decode_tokens_per_s": engine.stats["decode_tokens"] / wall,
        "kernel_launches": counts, "expected_launches": expect,
        "kernel_routes": routes, "expected_routes": expect_routes,
    })
    if on_card:
        out["peak_device_bytes"] = torch.cuda.max_memory_allocated(device)
    del engine, params
    if on_card:
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rehearse", action="store_true",
                    help="toy sizes on the CPU with the plain versions; "
                         "measures nothing")
    args = ap.parse_args(argv)

    if args.rehearse:
        device, sizes = torch.device("cpu"), TOY
    else:
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device: this run needs one GPU",
                  file=sys.stderr)
            return 1
        device, sizes = torch.device("cuda", 0), FULL
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(args.seed)

    env = phase_env(device)
    build = phase_build(device)
    rows = phase_kernels(sizes, device, gen, build)

    # The launch and streaming path: every count set to 0 just before, read
    # just after.
    zero_counts()
    launch = phase_launch(sizes, device, gen)
    stream = phase_stream(sizes, device, args.seed)
    counts = {name: w.launches for name, w in WRAPPERS.items()}
    routes = route_counts()
    # Each serving run zeroes and reads the counts around its engine run.
    serves = {arch: phase_serve(sizes, device, args.seed, arch)
              for arch in SERVE_ARCHS}
    served = {arch: out["kernel_launches"] for arch, out in serves.items()}
    dense, rwkv, hybrid = (served[arch] for arch in SERVE_ARCHS)
    hybrid_routes = serves[SERVE_ARCHS[2]]["kernel_routes"]["rg_lru"]

    mesh = launch["mesh"]
    mesh_gemm = sum(mesh["gemm"].get("kernel_launches", {}).values())
    per_row = {
        "kmeans": counts["kmeans"], "hotspot": counts["hotspot"],
        "cluster_sums": counts["cluster_sums"],
        "gemm": launch["gemm"]["kernel_launches"] + mesh_gemm,
        "gemm_bf16": launch["gemm_bf16"]["kernel_launches"],
        "black_scholes": counts["black_scholes"],
        "spmv_ell": counts["spmv_ell"], "md5": counts["md5"],
        "nbody": counts["nbody"], "correlate": counts["correlate"],
        "flash_attention": dense["flash_attention"]
        + hybrid["flash_attention"],
        "decode_attention": dense["decode_attention"]
        + hybrid["decode_attention"],
        "wkv6": rwkv["wkv6"], "rg_lru": hybrid["rg_lru"],
    }
    require(per_row["gemm"] + per_row["gemm_bf16"] == counts["gemm"])
    # The two kernels launched at more than one shape, split by shape.
    by_shape = {
        "kmeans": {"launch phase": launch["kmeans"]["kernel_launches"],
                   "mesh pass":
                   mesh["kmeans"].get("kernel_launches"),
                   "stream phase": stream.get("kernel_launches")},
        "rg_lru": {"prefills (route chunk)": hybrid_routes["chunk"],
                   "prefills and decode steps (route fma)":
                   hybrid_routes["fma"]}}
    for row in rows:
        row["launches"] = per_row[row["name"]]
        if row["name"] in by_shape:
            row["launches_by_shape"] = by_shape[row["name"]]
        if device.type == "cuda" and row["launches"] < 1:
            raise AssertionError(
                f"{row['name']}: the main path never launched this kernel")
    emit({"phase": "total", "seconds": time.perf_counter() - t0,
          "main_path_launches": counts, "main_path_routes": routes,
          "stream_launches": stream.get("kernel_launches"),
          "serve_launches": served})

    if args.rehearse:
        emit({"kernels": rows})
        emit({"ok": False, "rehearsal": True,
              "device": {"platform": "cpu", "kind": "cpu", "count": 0}})
        return 0
    emit({"kernels": rows})
    print(env["card"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

builds the CUDA kernels from ``src/repro_torch/csrc``, holds each against
its plain PyTorch version on the card, and drives the port's main path —
annotated-kernel launches through ``Context.launch`` (the 1-D stencil,
HotSpot, K-Means, co-clustering sums, GEMM, and the paper's section 4.2
benchmarks Black-Scholes, SpMV, MD5 and N-Body) and host-memory streaming
through ``stream_kmeans`` — at sizes a user of the paper's benchmarks would
call real.  Phases (each prints one JSON line with the
seconds it took): ``env``, ``build``, ``kernels``, ``launch``, ``stream``.
Any exception or any comparison outside its tolerance ends the run with a
non-zero exit code.  The last three lines of the output are the kernel
table, the card's name and power limit, and the verdict.

It needs a CUDA device and fails without one.  ``--rehearse`` runs the same
control flow at toy sizes on the CPU with the plain versions, to find wrong
paths and shapes where there is no card; it measures nothing and its last
line says ``"ok": false``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

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
from repro_torch.core.streaming import stream_kmeans  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    _build,
    black_scholes,
    black_scholes_ref,
    cluster_sums,
    cluster_sums_ref,
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
    spmv_ell,
    spmv_ell_ref,
)
from repro_torch.kernels.black_scholes.kernel import (  # noqa: E402
    black_scholes_cuda,
)
from repro_torch.kernels.common import (  # noqa: E402
    H100_SXM_BF16_FLOPS,
    H100_SXM_FP32_FLOPS,
    H100_SXM_HBM_BYTES_PER_S,
    H100_SXM_INT32_OPS,
)
from repro_torch.kernels.coclustering.kernel import (  # noqa: E402
    cluster_sums_cuda,
)
from repro_torch.kernels.gemm.kernel import gemm_cuda  # noqa: E402
from repro_torch.kernels.kmeans.kernel import kmeans_cuda  # noqa: E402
from repro_torch.kernels.md5.kernel import md5_search_cuda  # noqa: E402
from repro_torch.kernels.md5.ref import KEY_XOR, word_index  # noqa: E402
from repro_torch.kernels.nbody.kernel import nbody_cuda  # noqa: E402
from repro_torch.kernels.nbody.ref import SOFTENING2  # noqa: E402
from repro_torch.kernels.spmv_ell.kernel import spmv_ell_cuda  # noqa: E402
from repro_torch.kernels.stencil2d.kernel import hotspot_cuda  # noqa: E402

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
}


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
    md5_n: int = 1 << 30  # keys
    nbody_n: int = 1 << 17  # bodies
    nbody_slab: int = 1024  # targets held against the float64 version
    reps: int = 5


FULL = Sizes()
TOY = Sizes(stencil_n=1 << 12, hotspot=(96, 160), hotspot_steps=3,
            kmeans_n=1 << 12, kmeans_iters=2, csums=(192, 320), gemm=96,
            stream_n=(1 << 13) + 100, stream_chunk_rows=1 << 11,
            stream_iters=2, bs_n=(1 << 12) + 3, spmv=((1 << 10) + 8, 16),
            md5_n=1 << 13, nbody_n=1000, nbody_slab=256,
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


def time_ms(fn, device: torch.device, reps: int,
            warmup: bool = True) -> float | None:
    """Median of ``reps`` runs after one warm-up, by CUDA events.  Every
    timed shape is larger than the L2 cache, so no flush is needed.  A
    plain version that takes seconds is timed once, without a warm-up."""
    if warmup or device.type != "cuda":
        fn()
        sync(device)
    if device.type != "cuda":
        return None  # a rehearsal measures nothing
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


def md5_int_ops_per_key() -> int:
    """The fewest 32-bit integer instructions one key needs, counted from
    ``md5_u32x2`` with every constant folded.  A round is the 3-input logic
    function (one LOP3), ``a + f + (K + m[g])`` (one IADD3, as K + m[g]
    folds to a constant; two where m[g] is a key word) and
    ``b + rotl(sum, s)`` (one LEA.HI, a funnel shift and add in one): 3.
    Round 0 works on constants until it adds w0: 2.  Rounds 1-3 add to a
    constant ``a``, so a key word costs them nothing more.  Then the second
    message word (one xor) and four compares, with the final adds folded
    into the target.  The build phase's SASS counts show the same forms."""
    key_word_rounds = sum(word_index(i) in (0, 1) for i in range(4, 64))
    return 2 + 63 * 3 + key_word_rounds + 1 + 4


def nbody_inputs(n, gen, device):
    """Positions uniform in the unit cube, masses uniform in [0.5, 1.5)
    (the reference sweep's bodies)."""
    posm = torch.rand((n, 4), generator=gen, device=device)
    posm[:, 3] += 0.5
    return (posm,)


#: flops one N-Body pair needs: 3 subtractions, |d|^2 + eps^2 (3 multiply-
#: adds, 6 flops), rsqrt (1), m / dist^3 (3 multiplies), 3 multiply-adds
#: into the sum (6)
NBODY_FLOPS_PER_PAIR = 19


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


def nbody_term_scale(posm, lo, hi):
    """``sum_j |term_ij|`` for targets [lo, hi), per axis, in posm's type:
    the size of the sum that an N-Body error is held against."""
    pos, mass = posm[:, :3], posm[:, 3]
    d = pos[None, :, :] - pos[lo:hi, None, :]
    dist2 = (d * d).sum(dim=-1) + SOFTENING2
    return torch.einsum("ij,ijk->ik",
                        mass[None, :] * torch.rsqrt(dist2) / dist2, d.abs())


def nbody_slab_check(name, got, plain, posm, lo, hi):
    """Accelerations of targets [lo, hi) against the plain version in
    float64, per target and axis within ``1e-4 * sum_j |term_ij|``: a sum
    of n f32 terms cannot be held to an absolute 5e-4 at n = 2**17.  The
    kernel's rows (``got``) and the f32 plain version's (``plain``) both."""
    p64 = posm.double()
    want = nbody_forces_ref(p64, rows=(lo, hi))
    scale = nbody_term_scale(p64, lo, hi)
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


def sass_instructions(lib) -> dict:
    """Opcode counts of each kernel in the built library, by the
    ``cuobjdump`` beside ``nvcc``."""
    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    return sass_opcode_counts(subprocess.run(
        [cuobjdump, "-sass", str(lib)], check=True, capture_output=True,
        text=True).stdout)


def phase_build(device: torch.device) -> None:
    t0 = time.perf_counter()
    info = {"phase": "build"}
    if device.type == "cuda":
        _build.load()
        info["nvcc_seconds"] = _build.build_seconds
        info["sources"] = [p.name for p in _build.sources()]
        info["sass"] = sass_instructions(_build.build())
        # Registers, shared memory and spills of each kernel, from ptxas.
        usage = [ln.strip() for ln in _build.build_log().splitlines()
                 if "registers" in ln or "spill" in ln]
        print("\n".join(usage), file=sys.stderr)
    else:
        info["skipped"] = "rehearsal on the CPU: nothing to build"
    info["seconds"] = time.perf_counter() - t0
    emit(info)


def kernel_cases(sizes: Sizes, device: torch.device, gen: torch.Generator):
    """One dict per kernel entry: how to make inputs at the main-path shape
    and at a ragged shape of the reference sweep, the public function, the
    plain version, an optional library call, the tolerance with its
    reason, and the least work the function needs."""
    g = sizes.gemm

    def kmeans_make(n, k, f):
        if (k, f) == (KM_K, KM_F):
            centers = lattice_centers(gen, device)
            return (clustered_points(n, centers, gen),
                    start_centroids(centers, gen))
        # The ragged case keeps the sweep's shape (n=1000, k=7, f=4) with
        # separated clusters, so that the counts compare exactly.
        centers = 4.0 * torch.arange(k, device=device, dtype=torch.float32
                                     )[:, None].repeat(1, f)
        return clustered_points(n, centers, gen), start_centroids(centers, gen)

    def kmeans_check(name, got, want, points):
        if not torch.equal(got[1], want[1]):
            raise AssertionError(f"{name}: counts differ: "
                                 f"{(got[1] - want[1]).abs().max()}")
        require(float(got[1].sum()) == float(points.shape[0]), name,
                "counts do not sum to n")
        return check_close(name, got[0], want[0], rtol=1e-4, atol=1e-3)

    def csums_check(name, got, want, z):
        err = check_close(name, got, want, rtol=1e-4, atol=1e-3)
        mass, total = float(got.double().sum()), float(z.double().sum())
        if abs(mass - total) > 1e-4 * abs(total):
            raise AssertionError(f"{name}: mass {mass} != {total}")
        return err

    def md5_check(name, got, want, n, target, expect):
        require(int(got) == int(want) == expect, name, "found", int(got),
                "plain", int(want), "expected", expect)
        return 0.0, 0.0

    def md5_main_check(name, got, want, n, target, expect):
        """Kernel and plain version over all n keys, and the kernel once
        more with no key matching."""
        md5_check(name, got, want, n, target, expect)
        none = int(md5_search(n, MD5_NO_MATCH, device=device))
        require(none == n, name, "no-match search gave", none, "not", n)
        return 0.0, 0.0

    def nbody_main_check(name, got, want, posm):
        """Every target against the f32 plain version within
        ``2e-4 * sum_j |term_ij|`` (two f32 sums of n terms, each held to
        1e-4 of it below), then a slab of targets, kernel and plain
        version both, against float64."""
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
        return nbody_slab_check(name, got[lo:lo + s], want[lo:lo + s], posm,
                                lo, lo + s)

    def gemm_case(name, dtype, tol, rate):
        return dict(
            name=name, wrapper="gemm", source="src/repro_torch/csrc/gemm.cu",
            replaces="src/repro/kernels/gemm/kernel.py:66",
            main=lambda: gemm_inputs(g, g, g, dtype, gen, device),
            ragged=lambda: gemm_inputs(100, 60, 130, dtype, gen, device),
            fn=lambda a, b: gemm(a, b),
            plain=lambda a, b: gemm_ref(a, b),
            library=lambda a, b: torch.matmul(a, b),
            check=lambda nm, got, want, *inp: check_close(
                nm, got, want, rtol=tol, atol=tol),
            work=lambda a, b: bound(
                (a.numel() + b.numel() + a.shape[0] * b.shape[1])
                * a.element_size(),
                2.0 * a.shape[0] * a.shape[1] * b.shape[1], rate),
            shape=lambda a, b: [a.shape[0], a.shape[1], b.shape[1]],
        )

    return [
        dict(
            name="kmeans", wrapper="kmeans",
            source="src/repro_torch/csrc/kmeans.cu",
            replaces="src/repro/kernels/kmeans/kernel.py:57",
            main=lambda: kmeans_make(sizes.kmeans_n, KM_K, KM_F),
            ragged=lambda: kmeans_make(1000, 7, 4),
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
        # f32: true f32 products; 1e-4 covers the order of summation.
        gemm_case("gemm", torch.float32, 1e-4, H100_SXM_FP32_FLOPS),
        # bf16: the result is rounded to bf16 (8 bits of mantissa): 2e-2.
        gemm_case("gemm_bf16", torch.bfloat16, 2e-2, H100_SXM_BF16_FLOPS),
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
        dict(
            name="spmv_ell", wrapper="spmv_ell",
            source="src/repro_torch/csrc/spmv_ell.cu",
            replaces="src/repro/kernels/spmv_ell/kernel.py:43",
            main=lambda: spmv_inputs(sizes.spmv[0], sizes.spmv[1],
                                     sizes.spmv[0], gen, device),
            # 16 entries a row (16-byte loads, 4 lanes a row) and 13 (single
            # loads, 16 lanes a row)
            ragged=lambda: [spmv_ragged_inputs(16, gen, device),
                            spmv_ragged_inputs(13, gen, device)],
            fn=lambda d, c, x: spmv_ell(d, c, x),
            plain=lambda d, c, x: spmv_ell_ref(d, c, x),
            library=lambda csr, x: torch.mv(csr, x),
            library_setup=ell_to_csr,
            # rtol 1e-5 atol 1e-6: the reference sweep's (order of a sum
            # of 16 terms).
            check=lambda nm, got, want, *inp: check_close(
                nm, got, want, rtol=1e-5, atol=1e-6),
            # data, cols and y once, x once; the random gather reads a
            # 32-byte sector per entry, so the real traffic is larger.
            work=lambda d, c, x: bound(
                (d.numel() + c.numel() + d.shape[0] + x.numel()) * 4.0,
                2.0 * d.numel(), H100_SXM_FP32_FLOPS),
            shape=lambda d, c, x: [d.shape[0], d.shape[1], x.numel()],
        ),
        dict(
            name="md5", wrapper="md5",
            source="src/repro_torch/csrc/md5.cu",
            replaces="src/repro/kernels/md5/kernel.py:52",
            main=lambda: (sizes.md5_n,
                          md5_digest(sizes.md5_n - MD5_PLANT_BELOW_N),
                          sizes.md5_n - MD5_PLANT_BELOW_N),
            ragged=lambda: [(2048, md5_digest(0), 0),
                            (2048, md5_digest(1500), 1500),
                            (2048, MD5_NO_MATCH, 2048)],
            fn=lambda n, t, e: md5_search(n, t, device=device),
            plain=lambda n, t, e: md5_search_ref(n, t, device=device),
            plain_reps=1,
            library=None,
            # exact: an index
            check=md5_check,
            main_check=md5_main_check,
            # every key is hashed (no early exit), at the issue ceiling;
            # 16 bytes of target read, one int written
            work=lambda n, t, e: bound(20.0, float(n) * md5_int_ops_per_key(),
                                       H100_SXM_INT32_OPS),
            shape=lambda n, t, e: [n],
        ),
        dict(
            name="nbody", wrapper="nbody",
            source="src/repro_torch/csrc/nbody.cu",
            replaces="src/repro/kernels/nbody/kernel.py:64",
            main=lambda: nbody_inputs(sizes.nbody_n, gen, device),
            ragged=lambda: nbody_inputs(300, gen, device),
            fn=lambda p: nbody_forces(p),
            plain=lambda p: nbody_forces_ref(p),
            plain_reps=1,
            library=None,
            # rtol 5e-4 atol 5e-4: the reference sweep's, at n = 300; the
            # main shape is held to float64 (nbody_slab_check).
            check=lambda nm, got, want, *inp: check_close(
                nm, got, want, rtol=5e-4, atol=5e-4),
            main_check=nbody_main_check,
            work=lambda p: bound(p.shape[0] * 28.0,
                                 float(p.shape[0]) ** 2 * NBODY_FLOPS_PER_PAIR,
                                 H100_SXM_FP32_FLOPS),
            shape=lambda p: [p.shape[0]],
        ),
    ]


def phase_kernels(sizes: Sizes, device: torch.device,
                  gen: torch.Generator) -> list[dict]:
    """Each kernel against its plain version on the card, at the main-path
    shape and at one ragged shape, then timed at the main-path shape."""
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
        ragged_err = 0.0
        for inputs in raggeds:
            before = wrapper.launches
            got = case["fn"](*inputs)
            sync(device)
            if device.type == "cuda" and wrapper.launches != before + 1:
                raise AssertionError(f"{name}: the wrapper did not launch")
            ragged_err = max(ragged_err, case["check"](
                f"{name}/ragged", got, case["plain"](*inputs), *inputs)[0])
        ragged_shape = case["shape"](*raggeds[0])
        del raggeds, inputs, got

        inputs = case["main"]()
        got = case["fn"](*inputs)
        sync(device)
        plain_reps = case.get("plain_reps", sizes.reps)
        plain_ms = None
        if plain_reps == 1:
            # A plain version that takes seconds runs once, timed, and that
            # run is the one the kernel is held against.
            kept = []
            plain_ms = time_ms(lambda: kept.append(case["plain"](*inputs)),
                               device, 1, warmup=False)
            want = kept.pop()
        else:
            want = case["plain"](*inputs)
        abs_err, rel_err = case.get("main_check", case["check"])(
            f"{name}/main", got, want, *inputs)
        first = want[0] if isinstance(want, tuple) else want
        require(float(first.abs().max()) > 0, name, "compared all zeros")
        del got, want, first
        if plain_reps > 1:
            plain_ms = time_ms(lambda: case["plain"](*inputs), device,
                               plain_reps)
        bound_ms, bound_by = case["work"](*inputs)
        library_ms = None
        if case["library"]:
            lib_inputs = case.get("library_setup", lambda *a: a)(*inputs)
            library_ms = time_ms(lambda: case["library"](*lib_inputs),
                                 device, sizes.reps)
            del lib_inputs
        row = {
            "name": name, "route": "cuda", "source": case["source"],
            "replaces": case["replaces"], "launches": None,
            "max_abs_err": abs_err, "max_rel_err": rel_err,
            "ms": time_ms(lambda: case["fn"](*inputs), device, sizes.reps),
            "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
            "shape": case["shape"](*inputs),
            "ragged_shape": ragged_shape,
            "ragged_max_abs_err": ragged_err,
        }
        if plain_reps != sizes.reps:
            row["plain_runs"] = plain_reps
        rows.append(row)
        del inputs
        if device.type == "cuda":
            torch.cuda.empty_cache()
    emit({"phase": "kernels", "tf32": False, "rows": rows,
          "seconds": time.perf_counter() - t0})
    return rows


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
    def stencil_body(views, info):
        x = views["input"]
        zero = torch.zeros((1,), dtype=x.dtype, device=x.device)
        return {"output": (torch.cat([zero, x[:-1]]) + x
                           + torch.cat([x[1:], zero])) / 3.0}

    stencil = KernelDef.define(
        "stencil", stencil_body,
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
        "hotspot",
        lambda v, info: {"out": hotspot_step(v["temp"], v["power"])},
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
    def kmeans_body(v, info):
        sums, counts = kmeans_assign_reduce(v["points"], v["centroids"])
        return {"sums": sums, "counts": counts}

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
    cen, prev, trace = cen0, inertia(cen0), []
    for _ in range(sizes.kmeans_iters):
        res = ctx.launch(
            kmeans, grid=(n,), work_dist=BlockWork(max(1, n // 8)),
            args={"points": points,
                  "centroids": ctx.array(cen, name="centroids"),
                  "sums": sums, "counts": counts})
        cnt = res["counts"].value
        require(float(cnt.sum()) == float(n), "counts must sum to n")
        cen = res["sums"].value / cnt.clamp(min=1.0)[:, None]
        cur = inertia(cen)
        require(cur <= prev * 1.001, "inertia rose", prev, cur)
        prev = cur
        trace.append(cur)
    ctx.synchronize()
    comm = {k: v.value for k, v in ctx.records[-1].comm.items()}
    require(comm["sums"] == "reduce" and comm["counts"] == "reduce", comm)
    n_launched = launched("kmeans", since, sizes.kmeans_iters)
    want = cen0
    for _ in range(sizes.kmeans_iters):
        s, c = kmeans_assign_reduce_ref(pts, want)
        want = s / c.clamp(min=1.0)[:, None]
    require(torch.equal(c, cnt), "final counts differ from the plain version")
    err = check_close("launch/kmeans", cen, want, rtol=1e-4, atol=1e-3)
    out["kmeans"] = {
        "n": n, "f": KM_F, "k": KM_K, "iterations": sizes.kmeans_iters,
        "kernel_launches": n_launched, "inertia_on_sample": trace,
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
    for tag, dtype, tol in (("gemm", torch.float32, 1e-4),
                            ("gemm_bf16", torch.bfloat16, 2e-2)):
        t1 = time.perf_counter()
        a, b = gemm_inputs(g, g, g, dtype, gen, device)
        since = gemm_cuda.launches
        res = ctx.launch(
            gemm_def, grid=(g, g),
            args={"A": ctx.array(a, dist=RowDist(), name="A"),
                  "B": ctx.array(b, dist=RowDist(), name="B"),
                  "C": ctx.zeros((g, g), dtype=dtype, dist=RowDist(),
                                 name="C")})
        ctx.synchronize()
        err = check_close(f"launch/{tag}", res["C"].value, gemm_ref(a, b),
                          rtol=tol, atol=tol)
        out[tag] = {"shape": [g, g, g], "dtype": str(dtype),
                    "kernel_launches": launched("gemm", since, 1),
                    "max_abs_err": err[0],
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
    out["spmv_ell"] = {
        "rows": rows, "max_nnz": nnz, "n": rows, "comm": comm,
        "kernel_launches": launched("spmv_ell", since, 1),
        "max_abs_err": err[0], "seconds": time.perf_counter() - t1}
    del data, cols, x, res

    # (h) MD5: reduce(min) over the matching keys, once with the target
    # planted near the end and once with no key matching.  On one device
    # the body searches the whole grid.
    md5_def = KernelDef.define(
        "md5",
        lambda v, info: {"found": md5_search(
            info.grid[0], info.scalars["target"],
            device=v["found"].device).reshape(1)},
        "global i => reduce(min) found[:]", scalars=("target",))
    n = sizes.md5_n
    t1 = time.perf_counter()
    since = md5_search_cuda.launches
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
    out["md5"] = {"n": n, "answers": answers, "comm": comm,
                  "kernel_launches": launched("md5", since, 2),
                  "seconds": time.perf_counter() - t1}

    # (i) N-Body: all bodies replicated, accelerations by rows.
    nbody_def = KernelDef.define(
        "nbody", lambda v, info: {"acc": nbody_forces(v["posm"])},
        "global i => read posm[:,:], write acc[i,:]")
    n, s = sizes.nbody_n, sizes.nbody_slab
    t1 = time.perf_counter()
    (posm,) = nbody_inputs(n, gen, device)
    since = nbody_cuda.launches
    res = ctx.launch(
        nbody_def, grid=(n,), work_dist=BlockWork(n // 8),
        args={"posm": ctx.array(posm, name="posm"),
              "acc": ctx.zeros((n, 3), dist=RowDist(8), name="acc")})
    ctx.synchronize()
    comm = comm_of_last()
    require(comm == {"posm": "replicated", "acc": "local"}, comm)
    err = nbody_slab_check("launch/nbody", res["acc"].value[:s],
                           nbody_forces_ref(posm, rows=(0, s)), posm, 0, s)
    out["nbody"] = {
        "n": n, "checked_targets": s, "comm": comm,
        "kernel_launches": launched("nbody", since, 1),
        "max_abs_err": err[0], "seconds": time.perf_counter() - t1}
    del posm, res

    out["launch_records"] = len(ctx.records)
    out["launch_count_metric"] = ctx.registry.snapshot()
    out["seconds"] = time.perf_counter() - t0
    emit(out)
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
        out["kernel_launches"] = launched

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
    phase_build(device)
    rows = phase_kernels(sizes, device, gen)

    # The main path: every count set to 0 just before, read just after.
    for wrapper in WRAPPERS.values():
        wrapper.launches = 0
    launch = phase_launch(sizes, device, gen)
    stream = phase_stream(sizes, device, args.seed)
    counts = {name: w.launches for name, w in WRAPPERS.items()}

    per_row = {
        "kmeans": counts["kmeans"], "hotspot": counts["hotspot"],
        "cluster_sums": counts["cluster_sums"],
        "gemm": launch["gemm"]["kernel_launches"],
        "gemm_bf16": launch["gemm_bf16"]["kernel_launches"],
        "black_scholes": counts["black_scholes"],
        "spmv_ell": counts["spmv_ell"], "md5": counts["md5"],
        "nbody": counts["nbody"],
    }
    require(per_row["gemm"] + per_row["gemm_bf16"] == counts["gemm"])
    for row in rows:
        row["launches"] = per_row[row["name"]]
        if device.type == "cuda" and row["launches"] < 1:
            raise AssertionError(
                f"{row['name']}: the main path never launched this kernel")
    emit({"phase": "total", "seconds": time.perf_counter() - t0,
          "main_path_launches": counts,
          "stream_launches": stream.get("kernel_launches")})

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

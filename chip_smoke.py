#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

builds the CUDA kernels from ``src/repro_torch/csrc``, holds each against
its plain PyTorch version on the card, and drives the port's main path —
annotated-kernel launches through ``Context.launch`` and host-memory
streaming through ``stream_kmeans`` — at sizes a user of the paper's
benchmarks would call real.  Phases (each prints one JSON line with the
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
    cluster_sums,
    cluster_sums_ref,
    gemm,
    gemm_ref,
    hotspot_step,
    hotspot_step_ref,
    kmeans_assign_reduce,
    kmeans_assign_reduce_ref,
)
from repro_torch.kernels.common import (  # noqa: E402
    H100_SXM_BF16_FLOPS,
    H100_SXM_FP32_FLOPS,
    H100_SXM_HBM_BYTES_PER_S,
)
from repro_torch.kernels.coclustering.kernel import (  # noqa: E402
    cluster_sums_cuda,
)
from repro_torch.kernels.gemm.kernel import gemm_cuda  # noqa: E402
from repro_torch.kernels.kmeans.kernel import kmeans_cuda  # noqa: E402
from repro_torch.kernels.stencil2d.kernel import hotspot_cuda  # noqa: E402

#: the wrappers whose ``launches`` counters prove the path went through the
#: hand-written kernels
WRAPPERS = {
    "kmeans": kmeans_cuda,
    "hotspot": hotspot_cuda,
    "cluster_sums": cluster_sums_cuda,
    "gemm": gemm_cuda,
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
    reps: int = 5


FULL = Sizes()
TOY = Sizes(stencil_n=1 << 12, hotspot=(96, 160), hotspot_steps=3,
            kmeans_n=1 << 12, kmeans_iters=2, csums=(192, 320), gemm=96,
            stream_n=(1 << 13) + 100, stream_chunk_rows=1 << 11,
            stream_iters=2, reps=1)

KM_F, KM_K = 4, 40  # the paper's K-Means: 4 features, 40 clusters
CS_R, CS_C = 8, 6  # co-clustering example: 8 row and 6 column clusters


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def require(cond, *what) -> None:
    """A check that fails the run (kept under ``python -O``, unlike assert)."""
    if not cond:
        raise AssertionError(" ".join(str(w) for w in what) or "check failed")


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_ms(fn, device: torch.device, reps: int) -> float | None:
    """Median of ``reps`` runs after one warm-up, by CUDA events.  Every
    timed shape is larger than the L2 cache, so no flush is needed."""
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


def errors(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    got, want = got.double(), want.double()
    diff = (got - want).abs()
    rel = diff / want.abs().clamp_min(1e-30)
    nonzero = want != 0
    return (float(diff.max()),
            float(rel[nonzero].max()) if nonzero.any() else 0.0)


def check_close(name: str, got: torch.Tensor, want: torch.Tensor, *,
                rtol: float, atol: float) -> tuple[float, float]:
    """``|got - want| <= atol + rtol * |want|`` everywhere, else fail."""
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: result has non-finite values")
    g, w = got.double(), want.double()
    bad = (g - w).abs() > atol + rtol * w.abs()
    abs_err, rel_err = errors(got, want)
    if bad.any():
        raise AssertionError(
            f"{name}: {int(bad.sum())} of {bad.numel()} elements outside "
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


def phase_build(device: torch.device) -> None:
    t0 = time.perf_counter()
    info = {"phase": "build"}
    if device.type == "cuda":
        _build.load()
        info["nvcc_seconds"] = _build.build_seconds
        info["sources"] = [p.name for p in _build.sources()]
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
        inputs = case["ragged"]()
        before = wrapper.launches
        got = case["fn"](*inputs)
        sync(device)
        if device.type == "cuda" and wrapper.launches != before + 1:
            raise AssertionError(f"{name}: the wrapper did not launch")
        ragged_err = case["check"](f"{name}/ragged", got,
                                   case["plain"](*inputs), *inputs)
        ragged_shape = case["shape"](*inputs)
        del inputs, got

        inputs = case["main"]()
        got = case["fn"](*inputs)
        sync(device)
        want = case["plain"](*inputs)
        abs_err, rel_err = case["check"](f"{name}/main", got, want, *inputs)
        first = want[0] if isinstance(want, tuple) else want
        require(float(first.abs().max()) > 0, name, "compared all zeros")
        del got, want, first
        bound_ms, bound_by = case["work"](*inputs)
        row = {
            "name": name, "route": "cuda", "source": case["source"],
            "replaces": case["replaces"], "launches": None,
            "max_abs_err": abs_err, "max_rel_err": rel_err,
            "ms": time_ms(lambda: case["fn"](*inputs), device, sizes.reps),
            "plain_ms": time_ms(lambda: case["plain"](*inputs), device,
                                sizes.reps),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": (time_ms(lambda: case["library"](*inputs), device,
                                   sizes.reps)
                           if case["library"] else None),
            "shape": case["shape"](*inputs),
            "ragged_shape": ragged_shape,
            "ragged_max_abs_err": ragged_err[0],
        }
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

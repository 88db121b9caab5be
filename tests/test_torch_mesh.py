"""Launches over several workers: the port's ``Context`` on a mesh of
workers against the reference's, on the CPU.

In process, meshes of 1, 2, 4 and 8 workers and a (2, 4) mesh run the
stencil (HALO, zeros at the end shards), GEMM (GATHER), column reductions
(REDUCE with +, min, max, *) and LOCAL and REPLICATED arguments; the
results are held against numpy and against the reference's ``Context``
with its planner on the same number of devices (the reference's own mesh
needs fake devices, so this process runs its single-device path, whose
results a correct mesh launch must give), and the recorded comm patterns
and specs against the reference's.  One ``slow`` test runs the
reference's ``Context`` on 8 fake devices in a subprocess
(``tests/_subproc.run_with_devices``) on the same seeded inputs as the
port's 8-worker ``Context`` and compares every output and record.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro_torch.core.mesh import assemble, shard_of
from repro_torch.kernels import hotspot_step as t_hotspot_step

from _subproc import run_with_devices

STENCIL = "global i => read input[i-1:i+1], write output[i]"
GEMM = "global [i, j] => read A[i,:], read B[:,j], write C[i,j]"
#: meshes as worker counts (a 1-D mesh "data") or a (2, 4) mesh
MESHES = [1, 2, 4, 8, (2, 4)]


def workers(mesh) -> int:
    return int(np.prod(mesh))


def port_ctx(mesh, **kw):
    if isinstance(mesh, tuple):
        return T.Context(mesh=T.make_mesh(mesh, ("pod", "data"),
                                          device="cpu"), **kw)
    return T.Context(device="cpu", num_workers=mesh, **kw)


def ref_ctx(mesh):
    """The reference's ``Context`` with its planner on as many devices
    as the mesh has workers: its comm patterns, and single-device results."""
    ctx = R.Context()
    ctx.topology = R.Topology(workers(mesh), 4)
    ctx.planner = R.Planner(ctx.topology)
    return ctx


def ref_spec(arr, pattern, mesh_axes):
    """The spec the reference's ``_execute_mesh`` gives an argument: () for
    a REPLICATED one, else its array's ``partition_spec`` on a mesh of
    ``mesh_axes`` (the reference reads only the axis names from it)."""
    if pattern == "replicated":
        return ()
    placed = R.DistributedArray(arr.name, arr.value, arr.dist,
                                mesh=object(), mesh_axes=mesh_axes)
    return tuple(placed.partition_spec())


def mesh_axes(mesh):
    return ("pod", "data") if isinstance(mesh, tuple) else ("data",)


def stencil_body(views, info):
    """The 1-D stencil on a halo'd view; a whole array (one worker) is
    padded with the zeros the end shards receive."""
    x = views["input"]
    if x.shape[0] == info.grid[0]:
        zero = x.new_zeros(1)
        x = torch.cat([zero, x, zero])
    return {"output": (x[:-2] + x[1:-1] + x[2:]) / 3.0}


def r_stencil_body(views, info):
    x = jnp.pad(views["input"], 1)
    return {"output": (x[:-2] + x[1:-1] + x[2:]) / 3.0}


def assert_records_match(trec, rrec, rargs, axes):
    rcomm = {k: v.value for k, v in rrec.comm.items()}
    assert {k: v.value for k, v in trec.comm.items()} == rcomm
    if len(trec.in_specs) and any(trec.in_specs.values()):
        for name, spec in trec.in_specs.items():
            assert spec == ref_spec(rargs[name], rcomm[name], axes), name


@pytest.mark.parametrize("mesh", MESHES)
def test_stencil_halo_with_zero_ends(mesh):
    n, k = 512, workers(mesh)
    x = np.random.RandomState(1).rand(n).astype(np.float32)
    ctx, rctx = port_ctx(mesh), ref_ctx(mesh)
    a = ctx.array(x, dist=T.StencilDist(n // k, 1), name="input")
    b = ctx.zeros((n,), dist=T.StencilDist(n // k, 1), name="output")
    ra = rctx.array(x, dist=R.StencilDist(n // k, 1), name="input")
    rb = rctx.zeros((n,), dist=R.StencilDist(n // k, 1), name="output")
    tk = T.KernelDef.define("stencil", stencil_body, STENCIL)
    rk = R.KernelDef.define("stencil", r_stencil_body, STENCIL)
    want = x
    for _ in range(3):
        res = ctx.launch(tk, grid=(n,), work_dist=T.BlockWork(n // k),
                         args={"input": a, "output": b})
        rres = rctx.launch(rk, grid=(n,), work_dist=R.BlockWork(n // k),
                           args={"input": ra, "output": rb})
        a, b = res["output"], a
        ra, rb = rres["output"], ra
        pad = np.pad(want, 1)
        want = (pad[:-2] + pad[1:-1] + pad[2:]) / np.float32(3.0)
    np.testing.assert_allclose(a.to_numpy(), want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(a.to_numpy(), np.asarray(ra.value),
                               rtol=1e-6, atol=1e-7)
    rec = ctx.records[-1]
    assert_records_match(rec, rctx.records[-1], {"input": rb, "output": ra},
                         mesh_axes(mesh))
    if k > 1:
        assert rec.comm["input"] is T.CommPattern.HALO
        assert rec.in_specs == {"input": (mesh_axes(mesh)[0],),
                                "output": (mesh_axes(mesh)[0],)}
        assert rec.out_specs == {"output": (mesh_axes(mesh)[0],)}
    assert ctx.num_devices == k


@pytest.mark.parametrize("mesh", MESHES)
def test_gemm_gathers_b(mesh):
    rng = np.random.RandomState(2)
    m = 64
    a_np, b_np = rng.rand(m, 48).astype(np.float32), \
        rng.rand(48, m).astype(np.float32)
    ctx, rctx = port_ctx(mesh), ref_ctx(mesh)
    calls = []

    def body(v, info):
        calls.append((info.device_index, info.thread_offset,
                      info.local_shape, tuple(v["A"].shape),
                      tuple(v["B"].shape)))
        return {"C": v["A"] @ v["B"]}

    args = {"A": ctx.array(a_np, dist=T.RowDist(), name="A"),
            "B": ctx.array(b_np, dist=T.RowDist(), name="B"),
            "C": ctx.zeros((m, m), dist=T.RowDist(), name="C")}
    rargs = {"A": rctx.array(a_np, dist=R.RowDist(), name="A"),
             "B": rctx.array(b_np, dist=R.RowDist(), name="B"),
             "C": rctx.zeros((m, m), dist=R.RowDist(), name="C")}
    res = ctx.launch(T.KernelDef.define("gemm", body, GEMM), grid=(m, m),
                     args=args)
    rres = rctx.launch(R.KernelDef.define(
        "gemm", lambda v, i: {"C": v["A"] @ v["B"]}, GEMM), grid=(m, m),
        args=rargs)
    np.testing.assert_allclose(res["C"].to_numpy(), a_np @ b_np, rtol=1e-5)
    np.testing.assert_allclose(res["C"].to_numpy(), np.asarray(
        rres["C"].value), rtol=1e-5)
    assert_records_match(ctx.records[-1], rctx.records[-1], rargs,
                         mesh_axes(mesh))
    k = workers(mesh)
    assert len(calls) == k
    if k > 1:
        assert ctx.records[-1].comm["B"] is T.CommPattern.GATHER
        # the reference's flat index and superblock: idx * (m / k) rows
        assert [c[:3] for c in calls] == [
            (w, (w * (m // k), 0), (m // k, m)) for w in range(k)]
        rows = m // T.make_mesh(mesh if isinstance(mesh, tuple) else (mesh,),
                                mesh_axes(mesh), device="cpu").shape[
                                    mesh_axes(mesh)[0]]
        assert all(c[3] == (rows, 48) and c[4] == (48, m) for c in calls)


def rows_over_all_axes(mod):
    """Rows split over every mesh axis (a spec entry naming them all), so
    that each worker holds distinct rows on a (2, 4) mesh too."""
    return mod.CustomDist(fn=lambda shape, nd: mod.RowDist().chunks(shape,
                                                                   nd),
                          spec_fn=lambda axes: (tuple(axes), None))


@pytest.mark.parametrize("op", ["+", "min", "max", "*"])
@pytest.mark.parametrize("mesh", MESHES)
def test_column_reduce(mesh, op):
    rng = np.random.RandomState(3)
    a_np = (0.9 + 0.2 * rng.rand(96, 24)).astype(np.float32)
    t_fn = {"+": torch.sum, "min": torch.amin, "max": torch.amax,
            "*": torch.prod}[op]
    r_fn = {"+": jnp.sum, "min": jnp.min, "max": jnp.max, "*": jnp.prod}[op]
    np_fn = {"+": np.sum, "min": np.min, "max": np.max, "*": np.prod}[op]
    ann = f"global [i, j] => read A[i,j], reduce({op}) s[j]"
    ctx, rctx = port_ctx(mesh), ref_ctx(mesh)
    args = {"A": ctx.array(a_np, dist=rows_over_all_axes(T), name="A"),
            "s": ctx.zeros((24,), dist=T.ReplicatedDist(), name="s")}
    rargs = {"A": rctx.array(a_np, dist=rows_over_all_axes(R), name="A"),
             "s": rctx.zeros((24,), dist=R.ReplicatedDist(), name="s")}
    res = ctx.launch(T.KernelDef.define(
        "colred", lambda v, i: {"s": t_fn(v["A"], dim=0)}, ann),
        grid=(96, 24), args=args)
    rres = rctx.launch(R.KernelDef.define(
        "colred", lambda v, i: {"s": r_fn(v["A"], axis=0)}, ann),
        grid=(96, 24), args=rargs)
    np.testing.assert_allclose(res["s"].to_numpy(), np_fn(a_np, axis=0),
                               rtol=1e-5)
    np.testing.assert_allclose(res["s"].to_numpy(), np.asarray(
        rres["s"].value), rtol=1e-5)
    rec = ctx.records[-1]
    assert rec.comm["s"] is T.CommPattern.REDUCE
    assert_records_match(rec, rctx.records[-1], rargs, mesh_axes(mesh))
    if workers(mesh) > 1:
        axes = mesh_axes(mesh)
        assert rec.in_specs["A"] == (axes if len(axes) > 1 else axes[0],
                                     None)
        assert rec.out_specs == {"s": ()}


@pytest.mark.parametrize("mesh", MESHES)
def test_local_and_replicated_arguments(mesh):
    n, k = 256, workers(mesh)
    rng = np.random.RandomState(4)
    x, w = rng.rand(n).astype(np.float32), rng.rand(16).astype(np.float32)
    ann = "global i => read x[i], read w[:], write y[i]"
    ctx, rctx = port_ctx(mesh), ref_ctx(mesh)
    args = {"x": ctx.array(x, dist=T.BlockDist(n // k), name="x"),
            "w": ctx.array(w, name="w"),
            "y": ctx.zeros((n,), dist=T.BlockDist(n // k), name="y")}
    rargs = {"x": rctx.array(x, dist=R.BlockDist(n // k), name="x"),
             "w": rctx.array(w, name="w"),
             "y": rctx.zeros((n,), dist=R.BlockDist(n // k), name="y")}
    seen = []

    def body(v, info):
        seen.append((v["x"].shape[0], v["w"].shape[0]))
        return {"y": v["x"] * v["w"].sum()}

    res = ctx.launch(T.KernelDef.define("scale", body, ann), grid=(n,),
                     work_dist=T.BlockWork(n // k), args=args)
    rres = rctx.launch(R.KernelDef.define(
        "scale", lambda v, i: {"y": v["x"] * v["w"].sum()}, ann), grid=(n,),
        work_dist=R.BlockWork(n // k), args=rargs)
    np.testing.assert_allclose(res["y"].to_numpy(), x * w.sum(), rtol=1e-6)
    np.testing.assert_allclose(res["y"].to_numpy(),
                               np.asarray(rres["y"].value), rtol=1e-6)
    rec = ctx.records[-1]
    assert_records_match(rec, rctx.records[-1], rargs, mesh_axes(mesh))
    if k > 1:
        assert {a: p.value for a, p in rec.comm.items()} == {
            "x": "local", "w": "replicated", "y": "local"}
        shards = n // T.make_mesh(
            mesh if isinstance(mesh, tuple) else (mesh,), mesh_axes(mesh),
            device="cpu").shape[mesh_axes(mesh)[0]]
        assert seen == [(shards, 16)] * k


def test_hotspot_over_workers_trims_the_zero_halo_at_the_ends():
    """The body a CUDA user writes on a mesh: the halo'd slab with the zero
    row dropped at the two end shards, so that the kernel's own clamp
    applies at the global edge: bit-equal to one worker."""
    rng = np.random.RandomState(5)
    temp = (rng.rand(64, 40) * 10 + 320).astype(np.float32)
    power = (rng.rand(64, 40) * 0.5).astype(np.float32)
    ann = ("global [i, j] => read temp[i-1:i+1, j-1:j+1], read power[i,j], "
           "write out[i,j]")

    def body(v, info):
        slab, p = v["temp"], v["power"]
        if slab.shape[0] == info.grid[0]:
            return {"out": t_hotspot_step(slab, p)}
        top = info.thread_offset[0] == 0
        bottom = info.thread_offset[0] + info.local_shape[0] == info.grid[0]
        slab = slab[int(top): slab.shape[0] - int(bottom)]
        pad = torch.zeros((1, p.shape[1]), dtype=p.dtype)
        p = torch.cat([pad] * (not top) + [p] + [pad] * (not bottom))
        out = t_hotspot_step(slab, p)
        return {"out": out[int(not top): out.shape[0] - int(not bottom)]}

    kd = T.KernelDef.define("hotspot", body, ann)
    results = []
    for k in (1, 4, 8):
        ctx = port_ctx(k)
        res = ctx.launch(kd, grid=(64, 40), work_dist=T.BlockWork(64 // k),
                         args={"temp": ctx.array(temp, dist=T.StencilDist(
                             64 // k, 1), name="temp"),
                               "power": ctx.array(power, dist=T.BlockDist(
                                   64 // k), name="power"),
                               "out": ctx.zeros((64, 40), dist=T.StencilDist(
                                   64 // k, 1), name="out")})
        results.append(res["out"].to_numpy())
        if k > 1:
            assert ctx.records[-1].comm["temp"] is T.CommPattern.HALO
    np.testing.assert_array_equal(results[1], results[0])
    np.testing.assert_array_equal(results[2], results[0])


@pytest.mark.parametrize("mesh", [2, 8, (2, 4)])
def test_a_sharded_axis_that_does_not_split_raises(mesh):
    ctx = port_ctx(mesh)
    with pytest.raises(ValueError, match="does not split"):
        ctx.array(np.ones(1001, np.float32), dist=T.RowDist(), name="x")
    # a replicated array of any length is fine
    ctx.array(np.ones(1001, np.float32), name="y")


def test_fault_injection_retries_a_mesh_launch():
    def run(ctx):
        k = T.KernelDef.define("double", lambda v, i: {"y": v["x"] * 2.0},
                               "global i => read x[i], write y[i]")
        x = ctx.array(np.arange(64, dtype=np.float32), dist=T.BlockDist(8),
                      name="x")
        out = ctx.launch(k, grid=(64,), work_dist=T.BlockWork(8),
                         args={"x": x, "y": ctx.zeros(
                             (64,), dist=T.BlockDist(8), name="y")})
        return out["y"].to_numpy(), [
            (e["kind"], e["attempt"]) for e in ctx.fault_events]

    def injector():
        return T.FaultInjector([T.fail_launch(at=0, times=2)], seed=0)

    policy = T.RecoveryPolicy(max_attempts=2)
    got, events = run(T.Context(device="cpu", num_workers=8,
                                fault_injector=injector(), recovery=policy))
    one, one_events = run(T.Context(device="cpu", fault_injector=injector(),
                                    recovery=policy))
    np.testing.assert_array_equal(got, np.arange(64) * 2.0)
    assert events == one_events == [("launch_failure", 1),
                                    ("launch_failure", 2),
                                    ("launch_recovered", 2)]
    with pytest.raises(RuntimeError, match="injected launch failure"):
        run(T.Context(device="cpu", num_workers=8, recovery=policy,
                      fault_injector=T.FaultInjector(
                          [T.fail_launch(at=0, times=0)], seed=0)))


def test_mesh_and_its_shards():
    mesh = T.make_mesh((2, 4), ("pod", "data"), device="cpu")
    assert mesh.shape == {"pod": 2, "data": 4} and mesh.size == 8
    assert mesh.axis_names == ("pod", "data")
    assert mesh.devices.shape == (2, 4) and mesh.devices.dtype == object
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    assert mesh.coords(6) == {"pod": 1, "data": 2}
    assert mesh.worker_at({"pod": 1, "data": 2}) == 6
    ctx = T.Context(mesh=mesh)
    assert ctx.device == torch.device("cpu") and ctx.num_devices == 8
    assert ctx.mesh_axes == ("pod", "data")
    a = ctx.array(np.arange(32, dtype=np.float32).reshape(8, 4),
                  dist=T.RowDist(), name="a")
    assert a.partition_spec() == ("pod", None)  # padded to rank 2
    assert a.sharding() == (mesh, ("pod", None))
    assert len(a.chunks()) == 8
    shards = a.shards()
    assert len(shards) == 8
    assert all(s.untyped_storage().data_ptr()
               == a.value.untyped_storage().data_ptr() for s in shards)
    np.testing.assert_array_equal(shards[5].numpy(), a.to_numpy()[4:])
    back = assemble(shards, a.partition_spec(), mesh, torch.device("cpu"))
    assert torch.equal(back, a.value)
    plain = T.Context(device="cpu").array(np.ones(4, np.float32), name="p")
    assert plain.partition_spec() == () and plain.sharding() is None
    assert [s.shape for s in plain.shards()] == [(4,)]


def test_shard_of_raises_on_an_uneven_split():
    mesh = T.make_mesh((2, 4), ("pod", "data"), device="cpu")
    with pytest.raises(ValueError, match="does not split"):
        shard_of(torch.zeros(4, 6), (None, ("pod", "data")), mesh, 0)


def test_a_mesh_needs_its_devices():
    with pytest.raises(ValueError, match="not both"):
        T.Context(device="cpu", num_workers=2,
                  mesh=T.make_mesh((2,), ("data",), device="cpu"))
    with pytest.raises(ValueError, match="at least 1"):
        T.Context(device="cpu", num_workers=0)
    with pytest.raises(ValueError, match="3 devices"):
        T.make_mesh((4,), ("data",), device=["cpu"] * 3)
    mesh = T.make_mesh((2,), ("data",), device=["cpu", "cpu"])
    assert mesh.worker_devices() == [torch.device("cpu")] * 2


def test_a_mesh_of_cuda_workers_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.make_mesh((4,), ("data",))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.make_mesh((4,), ("data",), device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.Context(num_workers=4)


@pytest.mark.parametrize("op", ["+", "min", "max", "*"])
def test_collective_reduce_in_worker_order(op):
    parts = [torch.tensor([1.5, -2.0, 3.0]) * (w + 1) for w in range(4)]
    got = T.collective_reduce(op, parts, ("data",))
    stacked = torch.stack(parts)
    want = {"+": stacked.sum(0), "min": stacked.amin(0),
            "max": stacked.amax(0), "*": stacked.prod(0)}[op]
    assert torch.equal(got, want)
    ints = [torch.tensor([2, 3], dtype=torch.int32)] * 3
    assert T.collective_reduce(op, ints, "data").dtype == torch.int32
    # no axes: nothing is combined
    assert T.collective_reduce(op, parts, ()) is parts[0]


def test_collective_reduce_refuses_another_op():
    with pytest.raises(ValueError, match="unsupported reduce op"):
        T.collective_reduce("xor", [torch.ones(2)] * 2, ("data",))


@pytest.mark.parametrize("workers_", [1, 4])
def test_quickstart_over_workers(workers_, capsys):
    from repro_torch.examples import quickstart

    quickstart.main(["--device", "cpu", "--n", "4096",
                     "--workers", str(workers_)])
    out = capsys.readouterr().out
    assert f"workers: {workers_}" in out
    assert "launches recorded: 10" in out
    if workers_ > 1:
        assert "'input': 'halo'" in out


# ---------------------------------------------------------------------------
# The reference on 8 fake devices, in a subprocess
# ---------------------------------------------------------------------------

REF_MESH_RUN = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.core import *
from repro.kernels.stencil2d.ops import hotspot_step

inp = dict(np.load(sys.argv[1]))
mesh = jax.make_mesh((8,), ("data",), axis_types=(jax.sharding.AxisType.Auto,))
ctx = Context(mesh=mesh, devices_per_node=4)
n, out, recs = inp["x"].shape[0], {}, {}

def record(tag):
    r = ctx.records[-1]
    recs[tag] = {"comm": {k: v.value for k, v in r.comm.items()},
                 "in_specs": {k: list(v) for k, v in r.in_specs.items()},
                 "out_specs": {k: list(v) for k, v in r.out_specs.items()}}

k = KernelDef.define("stencil", lambda v, i: {"output": (
    v["input"][:-2] + v["input"][1:-1] + v["input"][2:]) / 3.0},
    "global i => read input[i-1:i+1], write output[i]")
res = ctx.launch(k, grid=(n,), work_dist=BlockWork(n // 8), args={
    "input": ctx.array(inp["x"], dist=StencilDist(n // 8, 1), name="input"),
    "output": ctx.zeros((n,), dist=StencilDist(n // 8, 1), name="output")})
out["stencil"] = np.asarray(res["output"].value); record("stencil")

A, B = inp["a"], inp["b"]
k = KernelDef.define("gemm", lambda v, i: {"C": v["A"] @ v["B"]},
    "global [i, j] => read A[i,:], read B[:,j], write C[i,j]")
res = ctx.launch(k, grid=(A.shape[0], B.shape[1]), args={
    "A": ctx.array(A, dist=RowDist(), name="A"),
    "B": ctx.array(B, dist=RowDist(), name="B"),
    "C": ctx.zeros((A.shape[0], B.shape[1]), dist=RowDist(), name="C")})
out["gemm"] = np.asarray(res["C"].value); record("gemm")

fns = {"+": jnp.sum, "min": jnp.min, "max": jnp.max, "*": jnp.prod}
for tag, op in (("sum", "+"), ("min", "min"), ("max", "max"), ("prod", "*")):
    k = KernelDef.define("col" + tag, lambda v, i, f=fns[op]: {
        "s": f(v["A"], axis=0)},
        f"global [i, j] => read A[i,j], reduce({op}) s[j]")
    res = ctx.launch(k, grid=inp["r"].shape, args={
        "A": ctx.array(inp["r"], dist=RowDist(), name="A"),
        "s": ctx.zeros((inp["r"].shape[1],), dist=ReplicatedDist(),
                       name="s")})
    out["col" + tag] = np.asarray(res["s"].value); record("col" + tag)

k = KernelDef.define("scale", lambda v, i: {"y": v["x"] * v["w"].sum()},
    "global i => read x[i], read w[:], write y[i]")
res = ctx.launch(k, grid=(n,), work_dist=BlockWork(n // 8), args={
    "x": ctx.array(inp["x"], dist=BlockDist(n // 8), name="x"),
    "w": ctx.array(inp["w"], name="w"),
    "y": ctx.zeros((n,), dist=BlockDist(n // 8), name="y")})
out["scale"] = np.asarray(res["y"].value); record("scale")

rows = inp["temp"].shape[0]
def hot(v, i):
    p = jnp.pad(v["power"], ((1, 1), (0, 0)))
    return {"out": hotspot_step(v["temp"], p, use_ref=True)[1:-1]}
k = KernelDef.define("hotspot", hot,
    "global [i, j] => read temp[i-1:i+1, j-1:j+1], read power[i,j], "
    "write out[i,j]")
res = ctx.launch(k, grid=inp["temp"].shape, work_dist=BlockWork(rows // 8),
    args={"temp": ctx.array(inp["temp"], dist=StencilDist(rows // 8, 1),
                            name="temp"),
          "power": ctx.array(inp["power"], dist=BlockDist(rows // 8),
                             name="power"),
          "out": ctx.zeros(inp["temp"].shape, dist=StencilDist(rows // 8, 1),
                           name="out")})
out["hotspot"] = np.asarray(res["out"].value); record("hotspot")

try:
    ctx.array(np.ones(1001, np.float32), dist=RowDist(), name="odd")
    recs["uneven_raises"] = False
except Exception:
    recs["uneven_raises"] = True
np.savez(sys.argv[2], **out)
print("RECORDS=" + json.dumps(recs))
"""


@pytest.mark.slow
def test_eight_workers_match_the_reference_on_eight_devices(tmp_path):
    """Mirrors ``tests/test_multidevice.py::
    test_lightning_launch_patterns_multidevice``: the reference's
    ``Context(mesh=8 fake devices)`` and the port's 8-worker ``Context`` on
    the same seeded inputs, outputs at the reference test's tolerances
    (stencil 1e-6, GEMM 1e-4, reductions 1e-5) and every record equal."""
    rng = np.random.RandomState(0)
    n = 1024
    inp = {"x": rng.rand(n).astype(np.float32),
           "a": rng.rand(256, 256).astype(np.float32),
           "b": rng.rand(256, 256).astype(np.float32),
           "r": (0.9 + 0.2 * rng.rand(512, 32)).astype(np.float32),
           "w": rng.rand(16).astype(np.float32),
           "temp": (rng.rand(64, 48) * 10 + 320).astype(np.float32),
           "power": (rng.rand(64, 48) * 0.5).astype(np.float32)}
    np.savez(tmp_path / "in.npz", **inp)
    script = tmp_path / "ref_mesh.py"
    script.write_text(REF_MESH_RUN)
    stdout = run_with_devices(
        f"import runpy, sys; sys.argv = ['ref_mesh', "
        f"{str(tmp_path / 'in.npz')!r}, {str(tmp_path / 'out.npz')!r}]; "
        f"runpy.run_path({str(script)!r}, run_name='__main__')")
    recs = json.loads(stdout.split("RECORDS=")[1].strip())
    want = dict(np.load(tmp_path / "out.npz"))

    ctx = T.Context(mesh=T.make_mesh((8,), ("data",), device="cpu"),
                    devices_per_node=4)
    got, trecs = {}, {}

    def record(tag):
        r = ctx.records[-1]
        trecs[tag] = {"comm": {k: v.value for k, v in r.comm.items()},
                      "in_specs": {k: list(v) for k, v in r.in_specs.items()},
                      "out_specs": {k: list(v)
                                    for k, v in r.out_specs.items()}}

    k = T.KernelDef.define("stencil", lambda v, i: {"output": (
        v["input"][:-2] + v["input"][1:-1] + v["input"][2:]) / 3.0}, STENCIL)
    res = ctx.launch(k, grid=(n,), work_dist=T.BlockWork(n // 8), args={
        "input": ctx.array(inp["x"], dist=T.StencilDist(n // 8, 1),
                           name="input"),
        "output": ctx.zeros((n,), dist=T.StencilDist(n // 8, 1),
                            name="output")})
    got["stencil"] = res["output"].to_numpy()
    record("stencil")
    k = T.KernelDef.define("gemm", lambda v, i: {"C": v["A"] @ v["B"]}, GEMM)
    res = ctx.launch(k, grid=(256, 256), args={
        "A": ctx.array(inp["a"], dist=T.RowDist(), name="A"),
        "B": ctx.array(inp["b"], dist=T.RowDist(), name="B"),
        "C": ctx.zeros((256, 256), dist=T.RowDist(), name="C")})
    got["gemm"] = res["C"].to_numpy()
    record("gemm")
    fns = {"+": torch.sum, "min": torch.amin, "max": torch.amax,
           "*": torch.prod}
    for tag, op in (("sum", "+"), ("min", "min"), ("max", "max"),
                    ("prod", "*")):
        k = T.KernelDef.define("col" + tag, lambda v, i, f=fns[op]: {
            "s": f(v["A"], dim=0)},
            f"global [i, j] => read A[i,j], reduce({op}) s[j]")
        res = ctx.launch(k, grid=(512, 32), args={
            "A": ctx.array(inp["r"], dist=T.RowDist(), name="A"),
            "s": ctx.zeros((32,), dist=T.ReplicatedDist(), name="s")})
        got["col" + tag] = res["s"].to_numpy()
        record("col" + tag)
    k = T.KernelDef.define("scale", lambda v, i: {"y": v["x"] * v["w"].sum()},
                           "global i => read x[i], read w[:], write y[i]")
    res = ctx.launch(k, grid=(n,), work_dist=T.BlockWork(n // 8), args={
        "x": ctx.array(inp["x"], dist=T.BlockDist(n // 8), name="x"),
        "w": ctx.array(inp["w"], name="w"),
        "y": ctx.zeros((n,), dist=T.BlockDist(n // 8), name="y")})
    got["scale"] = res["y"].to_numpy()
    record("scale")

    def hot(v, i):
        p = torch.nn.functional.pad(v["power"], (0, 0, 1, 1))
        return {"out": t_hotspot_step(v["temp"], p, use_ref=True)[1:-1]}

    k = T.KernelDef.define(
        "hotspot", hot,
        "global [i, j] => read temp[i-1:i+1, j-1:j+1], read power[i,j], "
        "write out[i,j]")
    res = ctx.launch(k, grid=(64, 48), work_dist=T.BlockWork(8), args={
        "temp": ctx.array(inp["temp"], dist=T.StencilDist(8, 1), name="temp"),
        "power": ctx.array(inp["power"], dist=T.BlockDist(8), name="power"),
        "out": ctx.zeros((64, 48), dist=T.StencilDist(8, 1), name="out")})
    got["hotspot"] = res["out"].to_numpy()
    record("hotspot")
    with pytest.raises(ValueError, match="does not split"):
        ctx.array(np.ones(1001, np.float32), dist=T.RowDist(), name="odd")

    assert recs.pop("uneven_raises") is True
    assert trecs == recs
    assert trecs["stencil"]["comm"]["input"] == "halo"
    assert trecs["gemm"]["comm"]["B"] == "gather"
    assert trecs["colsum"]["comm"]["s"] == "reduce"
    assert trecs["hotspot"]["comm"]["temp"] == "halo"
    tol = {"stencil": 1e-6, "gemm": 1e-4, "colsum": 1e-5, "colmin": 1e-5,
           "colmax": 1e-5, "colprod": 1e-5, "scale": 1e-6}
    for tag, rtol in tol.items():
        np.testing.assert_allclose(got[tag], want[tag], rtol=rtol,
                                   err_msg=tag)
    # HotSpot: the reference sweep's tolerance, for rounding
    np.testing.assert_allclose(got["hotspot"], want["hotspot"], rtol=2e-5,
                               atol=2e-4)
    # and the stencil's zero ends against numpy
    pad = np.pad(inp["x"], 1)
    np.testing.assert_allclose(got["stencil"],
                               (pad[:-2] + pad[1:-1] + pad[2:]) / 3.0,
                               rtol=1e-6)

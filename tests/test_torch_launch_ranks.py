"""``Context.launch`` over ranks: the port's ``Context`` on a rank mesh (4
gloo ranks on the CPU, each holding only its own shards) against the
reference's ``Context`` on 4 fake devices and against the port's
one-controller ``Context`` on a mesh of 4 workers, on the same numpy
inputs.

One spawn a mesh shape, (4,) ``("data",)`` and (2, 2) ``("pod",
"data")``, runs every case of ``tests/_torch_launch_ranks.py`` in each
rank (start-up paid once); one reference subprocess runs the same cases on
both meshes, beside the spawns.  Outputs are held at the reference test's
tolerances (stencil 1e-6, GEMM 1e-4, reductions 1e-5), records equal to
the reference's; against the one-controller mesh outputs are bit-equal
outside REDUCE (within 1e-5 there: gloo adds the partials in its own
order) and records equal, plans included.
"""

import json

import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.core.mesh import shard_index
from repro_torch.dist import ranks

import _torch_dist_ranks
import _torch_launch_ranks as L
from _subproc import run_with_devices

MESHES = {"4": ((4,), ("data",)), "2x2": ((2, 2), ("pod", "data"))}
#: spawn's limit for the ranks of one mesh, in seconds
RANKS_TIMEOUT = 120
TOL = {"stencil": 1e-6, "gemm": 1e-4, "gemm_b_all_axes": 1e-4,
       "colsum": 1e-5, "colmin": 1e-5, "colmax": 1e-5, "colprod": 1e-5,
       "scale": 1e-6}
REDUCED = ("colsum", "colmin", "colmax", "colprod")

REFERENCE = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.core import *
from repro.kernels.stencil2d.ops import hotspot_step

inp = dict(np.load(sys.argv[1]))
SHAPES = {"4": ((4,), ("data",)), "2x2": ((2, 2), ("pod", "data"))}
fns = {"sum": ("+", jnp.sum), "min": ("min", jnp.min),
       "max": ("max", jnp.max), "prod": ("*", jnp.prod)}
rows_all = lambda: CustomDist(fn=lambda s, nd: RowDist().chunks(s, nd),
                              spec_fn=lambda axes: (tuple(axes), None))
out, recs = {}, {}
for key, (shape, axes) in SHAPES.items():
    mesh = jax.make_mesh(shape, axes,
                         axis_types=(jax.sharding.AxisType.Auto,) * len(axes))
    ctx = Context(mesh=mesh, devices_per_node=4)
    rec = recs[key] = {}
    def record(tag):
        r = ctx.records[-1]
        rec[tag] = {"comm": {k: v.value for k, v in r.comm.items()},
                    "in_specs": {k: list(v) for k, v in r.in_specs.items()},
                    "out_specs": {k: list(v) for k, v in r.out_specs.items()}}
    n, k = inp["x"].shape[0], 4
    kd = KernelDef.define("stencil", lambda v, i: {"output": (
        v["input"][:-2] + v["input"][1:-1] + v["input"][2:]) / 3.0},
        "global i => read input[i-1:i+1], write output[i]")
    a = ctx.array(inp["x"], dist=StencilDist(n // k, 1), name="input")
    b = ctx.zeros((n,), dist=StencilDist(n // k, 1), name="output")
    for _ in range(3):
        res = ctx.launch(kd, grid=(n,), work_dist=BlockWork(n // k),
                         args={"input": a, "output": b})
        a, b = res["output"], a
    out[key + "/stencil"] = np.asarray(a.value); record("stencil")
    m = inp["a"].shape[0]
    kd = KernelDef.define("gemm", lambda v, i: {"C": v["A"] @ v["B"]},
        "global [i, j] => read A[i,:], read B[:,j], write C[i,j]")
    for tag, bd in (("gemm", RowDist()), ("gemm_b_all_axes", rows_all())):
        res = ctx.launch(kd, grid=(m, m), args={
            "A": ctx.array(inp["a"], dist=RowDist(), name="A"),
            "B": ctx.array(inp["b"], dist=bd, name="B"),
            "C": ctx.zeros((m, m), dist=RowDist(), name="C")})
        out[key + "/" + tag] = np.asarray(res["C"].value); record(tag)
    rows, cols = inp["r"].shape
    for tag, (op, f) in fns.items():
        kd = KernelDef.define("col" + tag, lambda v, i, f=f: {
            "s": f(v["A"], axis=0)},
            f"global [i, j] => read A[i,j], reduce({op}) s[j]")
        res = ctx.launch(kd, grid=(rows, cols), args={
            "A": ctx.array(inp["r"], dist=rows_all(), name="A"),
            "s": ctx.zeros((cols,), dist=ReplicatedDist(), name="s")})
        out[key + "/col" + tag] = np.asarray(res["s"].value)
        record("col" + tag)
    kd = KernelDef.define("scale", lambda v, i: {"y": v["x"] * v["w"].sum()},
        "global i => read x[i], read w[:], write y[i]")
    res = ctx.launch(kd, grid=(n,), work_dist=BlockWork(n // k), args={
        "x": ctx.array(inp["x"], dist=BlockDist(n // k), name="x"),
        "w": ctx.array(inp["w"], name="w"),
        "y": ctx.zeros((n,), dist=BlockDist(n // k), name="y")})
    out[key + "/scale"] = np.asarray(res["y"].value); record("scale")
    rows, cols = inp["temp"].shape
    def hot(v, i):
        p = jnp.pad(v["power"], ((1, 1), (0, 0)))
        return {"out": hotspot_step(v["temp"], p, use_ref=True)[1:-1]}
    kd = KernelDef.define("hotspot", hot,
        "global [i, j] => read temp[i-1:i+1, j-1:j+1], read power[i,j], "
        "write out[i,j]")
    res = ctx.launch(kd, grid=(rows, cols), work_dist=BlockWork(rows // k),
        args={"temp": ctx.array(inp["temp"], dist=StencilDist(rows // k, 1),
                                name="temp"),
              "power": ctx.array(inp["power"], dist=BlockDist(rows // k),
                                 name="power"),
              "out": ctx.zeros((rows, cols), dist=StencilDist(rows // k, 1),
                               name="out")})
    out[key + "/hotspot"] = np.asarray(res["out"].value); record("hotspot")
    try:
        ctx.array(np.ones(1001, np.float32), dist=RowDist(), name="odd")
        rec["uneven_raises"] = False
    except Exception:
        rec["uneven_raises"] = True
np.savez(sys.argv[2], **out)
print("RECORDS=" + json.dumps(recs))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's run (one subprocess on 4 fake devices), the port's
    ranks (one spawn a mesh shape) and the one-controller mesh, on the same
    inputs."""
    tmp = tmp_path_factory.mktemp("launch_ranks")
    inp = L.inputs()
    np.savez(tmp / "in.npz", **inp)
    (tmp / "ref.py").write_text(REFERENCE)
    code = (f"import runpy, sys; sys.argv = ['ref', "
            f"{str(tmp / 'in.npz')!r}, {str(tmp / 'out.npz')!r}]; "
            f"runpy.run_path({str(tmp / 'ref.py')!r}, run_name='__main__')")
    port = {}
    with _torch_dist_ranks.beside(run_with_devices, code, n_devices=4,
                                  timeout=300) as ref:
        for key, (shape, axes) in MESHES.items():
            port[key] = ranks.spawn(
                L.suite, 4, backend="gloo", device="cpu",
                init_dir=str(tmp / f"rdv{key}"), args=(shape, axes, inp),
                timeout=RANKS_TIMEOUT)
    recs = json.loads(ref["result"].split("RECORDS=")[1].strip())
    want = dict(np.load(tmp / "out.npz"))
    one = {key: L.run_cases(T.Context(mesh=T.make_mesh(shape, axes,
                                                       device="cpu")), inp)
           for key, (shape, axes) in MESHES.items()}
    return inp, port, one, want, recs


def as_reference(records: dict) -> dict:
    """The records as the reference's run reports them: through JSON (a
    spec entry of two axes a list), without plans, and the trimmed HotSpot
    body's launch (the same annotation and distributions as the padded
    one's) left out."""
    return json.loads(json.dumps({
        tag: {k: v for k, v in r.items() if k != "tasks"}
        if isinstance(r, dict) else r
        for tag, r in records.items() if tag != "hotspot_trimmed"}))


def reference_all_axes_gather(inp: dict) -> np.ndarray:
    """What the reference's GEMM gives on (2, 2) with B's rows split over
    both axes: its gather runs over "pod" and then "data", which lays the
    row blocks out data-major (0, 2, 1, 3), where its placement
    (``NamedSharding``) and the port's ``shard_index`` count them
    row-major over ("pod", "data") (ROADMAP Queue C)."""
    blocks = np.split(inp["b"], 4)
    return inp["a"] @ np.concatenate([blocks[i] for i in (0, 2, 1, 3)])


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("tag", list(TOL) + ["hotspot"])
def test_outputs_match_the_reference_on_four_devices(runs, mesh, tag):
    inp, port, _, want, _ = runs
    if (mesh, tag) == ("2x2", "gemm_b_all_axes"):
        np.testing.assert_allclose(want[f"{mesh}/{tag}"],
                                   reference_all_axes_gather(inp), rtol=1e-4)
        want = {f"{mesh}/{tag}": inp["a"] @ inp["b"]}
    for rank, got in enumerate(port[mesh]):
        if tag == "hotspot":
            # the reference sweep's tolerance, for rounding
            np.testing.assert_allclose(got["out"][tag], want[f"{mesh}/{tag}"],
                                       rtol=2e-5, atol=2e-4)
        else:
            np.testing.assert_allclose(got["out"][tag], want[f"{mesh}/{tag}"],
                                       rtol=TOL[tag],
                                       err_msg=f"rank {rank}")


@pytest.mark.parametrize("mesh", list(MESHES))
def test_records_equal_the_reference_and_the_one_controller_mesh(runs, mesh):
    _, port, one, _, recs = runs
    for got in port[mesh]:
        assert as_reference(got["records"]) == recs[mesh]
        # plans included: every rank planned what one controller plans
        assert got["records"] == one[mesh]["records"]
    rec = port[mesh][0]["records"]
    assert rec["stencil"]["comm"]["input"] == "halo"
    assert rec["gemm"]["comm"]["B"] == "gather"
    assert rec["colsum"]["comm"]["s"] == "reduce"
    assert rec["scale"]["comm"] == {"x": "local", "w": "replicated",
                                    "y": "local"}
    assert rec["uneven_raises"] is True


@pytest.mark.parametrize("mesh", list(MESHES))
def test_ranks_equal_the_one_controller_mesh(runs, mesh):
    """Bit for bit outside REDUCE; the reductions within 1e-5."""
    _, port, one, _, _ = runs
    for rank, got in enumerate(port[mesh]):
        for tag, want in one[mesh]["out"].items():
            if tag in REDUCED:
                np.testing.assert_allclose(got["out"][tag], want, rtol=1e-5,
                                           err_msg=f"rank {rank} {tag}")
            else:
                np.testing.assert_array_equal(got["out"][tag], want,
                                              err_msg=f"rank {rank} {tag}")
    if mesh == "4":
        # the body a CUDA user writes: bit-equal to one worker
        inp = runs[0]
        whole = L.hotspot_step(torch.from_numpy(inp["temp"]),
                               torch.from_numpy(inp["power"]))
        np.testing.assert_array_equal(
            port[mesh][0]["out"]["hotspot_trimmed"], whole.numpy())


@pytest.mark.parametrize("mesh", list(MESHES))
def test_a_rank_holds_its_shard_and_reads_the_whole(runs, mesh):
    inp, port, one, _, _ = runs
    rows = 512 // MESHES[mesh][0][0]  # the stencil's split, the first axis
    for got in port[mesh]:
        assert got["held"] == {"stencil_input": (rows,),
                               "stencil_output": (rows,),
                               "stencil_global": (512,),
                               "colreduce_A": (24, 24)}
    assert one[mesh]["held"]["stencil_input"] == (512,)
    pad = np.pad(inp["x"], 1)
    first = (pad[:-2] + pad[1:-1] + pad[2:]) / np.float32(3.0)
    pad = np.pad(first, 1)
    second = (pad[:-2] + pad[1:-1] + pad[2:]) / np.float32(3.0)
    pad = np.pad(second, 1)
    third = (pad[:-2] + pad[1:-1] + pad[2:]) / np.float32(3.0)
    for got in port[mesh]:
        np.testing.assert_allclose(got["out"]["stencil"], third, rtol=1e-6)
        np.testing.assert_allclose(got["out"]["gemm"], inp["a"] @ inp["b"],
                                   rtol=1e-5)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_faults_agree_over_ranks(runs, mesh):
    """An injected launch fault: the same events on every rank and on one
    controller, and the one-controller result.  A real exception raised
    on one rank propagates there without a retry."""
    _, port, _, _, _ = runs
    shape, axes = MESHES[mesh]
    one = L.fault_case(T.Context(mesh=T.make_mesh(shape, axes, device="cpu"),
                                 fault_injector=L.fault_injector(),
                                 recovery=L.fault_policy()))
    assert one["events"] == [("launch_failure", 1), ("launch_failure", 2),
                             ("launch_recovered", 2)]
    for got in port[mesh]:
        assert got["fault"]["events"] == one["events"]
        np.testing.assert_array_equal(got["fault"]["y"], one["y"])
    assert [g["real_failure"] for g in port[mesh]] == [None, [], None, None]
    assert all(g["no_card_raises"] for g in port[mesh])


def test_pmin_and_the_tiled_gather_order_on_two_by_two(runs):
    """Flat index row-major over ("pod", "data"), as ``shard_index``
    counts a spec entry's axes; ``pmin`` on int64 under gloo."""
    _, port, _, _, _ = runs
    for rank, got in enumerate(port["2x2"]):
        assert got["axis_index"] == rank
        assert got["tiled"] == [0, 0, 1, 1, 2, 2, 3, 3]
        assert got["pmin"] == [97, 0, -3 * 2 ** 40]
    mesh = T.make_mesh((2, 2), ("pod", "data"), device="cpu")
    assert [shard_index(mesh, w, ("pod", "data")) for w in range(4)] == [
        (w, 4) for w in range(4)]


def test_quickstart_over_ranks_prints_what_workers_print(capsys):
    from repro_torch.examples import quickstart

    quickstart.main(["--device", "cpu", "--n", "4096", "--workers", "4"])
    workers = capsys.readouterr().out
    quickstart.main(["--device", "cpu", "--n", "4096", "--ranks", "4"])
    over_ranks = capsys.readouterr().out
    assert over_ranks == workers
    assert "workers: 4" in over_ranks and "'input': 'halo'" in over_ranks


def test_collective_reduce_ranks_needs_a_known_op():
    with pytest.raises(ValueError, match="unsupported reduce op"):
        T.collective_reduce_ranks("xor", torch.ones(2), ("data",))
    x = torch.ones(2)
    assert T.collective_reduce_ranks("+", x, ()) is x

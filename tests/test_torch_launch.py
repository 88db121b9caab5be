"""``Context.launch`` parity: the reference ``Context`` against the port's, on
the CPU.  Same numpy inputs, same annotations; results at rtol 1e-5 (f32
elementwise arithmetic in two frameworks), plans and bookkeeping exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
import repro.obs as Robs
import repro_torch.core as T
import repro_torch.obs as Tobs
from repro_torch.convert import (
    array_from_reference,
    dist_from_reference,
    work_from_reference,
)
from repro_torch.core.reductions import (
    REDUCE_FNS,
    combine,
    identity_for,
    reduce_stack,
)
from repro.core import reductions as r_red

from _torch_parity import plain, task_rows

STENCIL = "global i => read input[i-1:i+1], write output[i]"


def r_stencil_body(views, info):
    x = views["input"]
    left = jnp.concatenate([jnp.zeros((1,), x.dtype), x[:-1]])
    right = jnp.concatenate([x[1:], jnp.zeros((1,), x.dtype)])
    return {"output": (left + x + right) / 3.0}


def t_stencil_body(views, info):
    x = views["input"]
    zero = torch.zeros((1,), dtype=x.dtype)
    return {"output": (torch.cat([zero, x[:-1]]) + x
                       + torch.cat([x[1:], zero])) / 3.0}


def _ten_launches(n=256, **ctx_kw):
    x_np = np.random.RandomState(0).rand(n).astype(np.float32)
    dist, work = R.StencilDist(64, 1), R.BlockWork(64)

    rctx = R.Context(**ctx_kw.get("ref", {}))
    rk = R.KernelDef.define("stencil", r_stencil_body, STENCIL)
    ra = rctx.array(x_np, dist=dist, name="input")
    rb = rctx.zeros((n,), dist=dist, name="output")

    tctx = T.Context(device="cpu", **ctx_kw.get("port", {}))
    tk = T.KernelDef.define("stencil", t_stencil_body, STENCIL)
    ta = array_from_reference(tctx, "input", np.asarray(ra.value), ra.dist)
    tb = tctx.zeros((n,), dist=dist_from_reference(dist), name="output")

    for _ in range(10):
        res = rctx.launch(rk, grid=(n,), args={"input": ra, "output": rb},
                          work_dist=work)
        ra, rb = res["output"], ra
        res = tctx.launch(tk, grid=(n,), args={"input": ta, "output": tb},
                          work_dist=work_from_reference(work))
        ta, tb = res["output"], ta
    return x_np, rctx, ra, tctx, ta


def test_ten_launch_stencil_matches_reference_context():
    x_np, rctx, ra, tctx, ta = _ten_launches()
    np.testing.assert_allclose(ta.to_numpy(), ra.to_numpy(), rtol=1e-5,
                               atol=1e-6)
    want = x_np.copy()
    for _ in range(10):
        pad = np.pad(want, 1)
        want = (pad[:-2] + pad[1:-1] + pad[2:]) / 3.0
    np.testing.assert_allclose(ta.to_numpy(), want, rtol=1e-5, atol=1e-6)
    assert len(tctx.records) == len(rctx.records) == 10


def test_records_comm_and_shared_plan_equal():
    _, rctx, ra, tctx, ta = _ten_launches()
    for rrec, trec in zip(rctx.records, tctx.records):
        assert ({k: v.value for k, v in trec.comm.items()}
                == {k: v.value for k, v in rrec.comm.items()})
        assert [plain(a) for a in trec.plan.args] \
            == [plain(a) for a in rrec.plan.args]
        assert trec.in_specs == {"input": (), "output": ()}
        assert trec.out_specs == {"output": ()}
    assert tctx.records[-1].comm["input"] is T.CommPattern.HALO
    # the stitched DAG (cross-launch dependency edges) is the same
    assert task_rows(tctx.plan) == task_rows(rctx.plan)
    assert ta.name == ra.name and plain(ta.dist) == plain(ra.dist)
    assert plain(ta.meta()) == plain(ra.meta())


def test_spans_and_counters_equal():
    def tracer(mod):
        ticks = iter(range(10_000))
        return mod.Tracer(clock=lambda: float(next(ticks)))

    rreg, treg = Robs.MetricsRegistry(), Tobs.MetricsRegistry()
    rtr, ttr = tracer(Robs), tracer(Tobs)
    _ten_launches(ref=dict(tracer=rtr, registry=rreg),
                  port=dict(tracer=ttr, registry=treg))
    assert treg.snapshot() == rreg.snapshot()
    assert treg.snapshot()["launch.count{kernel=stencil}"] == 10.0
    assert ttr.to_json() == rtr.to_json()


@pytest.mark.parametrize("specs,recovers", [
    ([("at", 0), ("at", 2)], True),   # first launch fails once, second once
    ([("always", 0)], False),         # every attempt fails: propagates
])
def test_fail_launch_injection_same_events_and_counters(specs, recovers):
    def injector(mod):
        made = [mod.fail_launch(at=a) if kind == "at"
                else mod.fail_launch(at=a, times=0) for kind, a in specs]
        return mod.FaultInjector(made, seed=0)

    x = np.arange(64, dtype=np.float32)
    outcomes = []
    for mod, dev, body in (
        (R, {}, lambda v, i: {"y": v["x"] * 2.0}),
        (T, {"device": "cpu"}, lambda v, i: {"y": v["x"] * 2.0}),
    ):
        reg = (Robs if mod is R else Tobs).MetricsRegistry()
        ctx = mod.Context(fault_injector=injector(mod), registry=reg,
                          recovery=mod.RecoveryPolicy(max_attempts=2), **dev)
        k = mod.KernelDef.define("double", body,
                                 "global i => read x[i], write y[i]")
        xa, ya = ctx.array(x, name="x"), ctx.zeros((64,), name="y")
        if recovers:
            out = ctx.launch(k, grid=(64,), args={"x": xa, "y": ya})
            ctx.launch(k, grid=(64,), args={"x": xa, "y": ya})
            np.testing.assert_array_equal(out["y"].to_numpy(), x * 2.0)
            # functional update: a retry found the inputs as they were
            np.testing.assert_array_equal(xa.to_numpy(), x)
        else:
            with pytest.raises(RuntimeError, match="injected launch failure"):
                ctx.launch(k, grid=(64,), args={"x": xa, "y": ya})
        outcomes.append((
            [(e["kind"], e["launch"], e["attempt"]) for e in ctx.fault_events],
            reg.snapshot(), len(ctx.records),
            [plain(e) for e in ctx.fault_injector.events],
        ))
    assert outcomes[1] == outcomes[0]
    kinds = [k for k, _, _ in outcomes[1][0]]
    if recovers:
        assert kinds.count("launch_failure") == 2
        assert kinds.count("launch_recovered") == 2
    else:
        assert kinds == ["launch_failure"] * 3  # initial + 2 retries


def test_real_exception_in_body_is_retried_then_raised():
    calls = []

    def body(v, i):
        calls.append(1)
        raise ValueError("boom")

    ctx = T.Context(device="cpu", fault_injector=T.FaultInjector([]),
                    recovery=T.RecoveryPolicy(max_attempts=1))
    k = T.KernelDef.define("bad", body, "global i => read x[i], write y[i]")
    with pytest.raises(ValueError, match="boom"):
        ctx.launch(k, grid=(4,), args={"x": ctx.ones((4,), name="x"),
                                       "y": ctx.zeros((4,), name="y")})
    assert len(calls) == 2 and len(ctx.fault_events) == 2


def test_reduce_launch_and_gemm_launch_match_reference():
    rng = np.random.RandomState(3)
    a_np = rng.rand(96, 32).astype(np.float32)
    b_np = rng.rand(32, 96).astype(np.float32)
    results = []
    for mod, dev, colsum, mm in (
        (R, {}, lambda v, i: {"s": v["A"].sum(axis=0)},
         lambda v, i: {"C": v["A"] @ v["B"]}),
        (T, {"device": "cpu"}, lambda v, i: {"s": v["A"].sum(dim=0)},
         lambda v, i: {"C": v["A"] @ v["B"]}),
    ):
        ctx = mod.Context(**dev)
        kr = mod.KernelDef.define(
            "colsum", colsum, "global [i, j] => read A[i,j], reduce(+) s[j]")
        A = ctx.array(a_np, dist=mod.RowDist(), name="A")
        s = ctx.zeros((32,), dist=mod.ReplicatedDist(), name="s")
        res = ctx.launch(kr, grid=(96, 32), args={"A": A, "s": s})
        kg = mod.KernelDef.define(
            "gemm", mm,
            "global [i, j] => read A[i,:], read B[:,j], write C[i,j]")
        B = ctx.array(b_np, dist=mod.RowDist(), name="B")
        C = ctx.zeros((96, 96), dist=mod.RowDist(), name="C")
        res2 = ctx.launch(kg, grid=(96, 96), args={"A": A, "B": B, "C": C})
        results.append((res["s"].to_numpy(), res2["C"].to_numpy(),
                        [{k: v.value for k, v in r.comm.items()}
                         for r in ctx.records]))
    np.testing.assert_allclose(results[1][0], results[0][0], rtol=1e-5)
    np.testing.assert_allclose(results[1][1], results[0][1], rtol=1e-5)
    assert results[1][2] == results[0][2]
    assert results[1][2][0]["s"] == "reduce"


def test_context_factories_and_array_metadata():
    ctx = T.Context(device="cpu")
    z = ctx.zeros((3, 4), name="z")
    o = ctx.ones((5,), dtype=torch.int32)
    f = ctx.full((2, 2), 7.5, dist=T.RowDist())
    assert z.shape == (3, 4) and z.dtype == torch.float32 and z.nbytes == 48
    assert o.name.startswith("arr_") and o.dtype == torch.int32
    assert float(f.value.sum()) == 30.0 and isinstance(f.dist, T.RowDist)
    assert isinstance(z.dist, T.ReplicatedDist)
    assert z.device == torch.device("cpu")
    assert z.read_region(T.Region.of((1, 3), (0, 2))).shape == (2, 2)
    assert [c.region.shape for c in z.chunks()] == [(3, 4)]
    z2 = z.replace_value(torch.ones(3, 4))
    assert z2.name == "z" and float(z.value.sum()) == 0.0
    assert ctx.num_devices == 1
    ctx.synchronize(z)  # a no-op on the CPU; must not raise


def test_more_than_one_worker_names_the_roadmap_item():
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A item 7"):
        T.Context(device="cpu", num_workers=4)


@pytest.mark.parametrize("op", ["+", "*", "min", "max"])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_reductions_match_reference(op, dtype):
    rng = np.random.RandomState(5)
    parts = [(rng.rand(6) * 4 + 1).astype(dtype) for _ in range(3)]
    want = r_red.reduce_stack(op, [jnp.asarray(p) for p in parts])
    tdt = getattr(torch, dtype)
    got = reduce_stack(op, [torch.from_numpy(p) for p in parts])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    ident = identity_for(op, tdt)
    assert ident.dtype == tdt
    assert float(ident) == float(r_red.identity_for(op, jnp.dtype(dtype)))
    first = torch.from_numpy(parts[0])
    assert torch.equal(combine(op, first, ident.expand(6)), first)
    assert set(REDUCE_FNS) == set(r_red.REDUCE_FNS)

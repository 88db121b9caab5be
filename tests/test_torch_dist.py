"""The port's distribution layer (``repro_torch.dist``, ``launch.rules``,
``launch.mesh``) against the reference's, on the CPU.

Sharding rules and partition specs are compared exactly, in this process.
The collectives run once in each package on the same numpy inputs: the
reference on 4 fake devices in one subprocess (``shard_map``), the port on
4 gloo ranks started by ``repro_torch.dist.ranks.spawn``, each rank a
process on the CPU.  Tolerances: the ring all-reduce within 1e-6 relative
of the reference and exactly on integer values; the ring collective
matmul at rtol 1e-4 against x @ w; the hierarchical all-reduce at 1e-5
against a flat psum; ``compressed_psum`` within 1e-6 of the reference and
within ``scale * n * 1.01 + 1e-5`` of the true sum; the flash-decode
combine at 1e-5 against the reference's combine of the same partials and
against attention over the whole cache.
"""

from __future__ import annotations

import types

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from jax.sharding import PartitionSpec as P

import repro.dist.sharding as RS
import repro.launch.rules as RR
from repro.configs import ARCHS
from repro.configs import get_config as r_config
from repro.train import train_loop as r_train
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import spec_from_reference
from repro_torch.dist import collectives, ranks, set_tracer
from repro_torch.dist import sharding as TS
from repro_torch.kernels.decode_attention.ref import (
    EMPTY_LSE,
    decode_attention_ref,
)
from repro_torch.launch import rules as TR
from repro_torch.launch.mesh import data_axes_of
from repro_torch.obs.trace import NULL_TRACER, Tracer
from repro_torch.train.train_loop import train_state_specs

from _subproc import run_with_devices
import _torch_dist_ranks

#: spawn's limit for the ranks of one test, in seconds
RANKS_TIMEOUT = 120

# -- rules and specs ----------------------------------------------------------


def _ref_tree(tree):
    """A reference spec tree with every PartitionSpec as the port's tuple."""
    return jax.tree.map(spec_from_reference, tree,
                        is_leaf=lambda x: isinstance(x, P) or x is None)


@pytest.mark.parametrize("case", [
    ("global [i, j] => read inp[i-1:i+1, j-1:j+1], write out[i,j]",
     ("y", "x"), {"y": "data", "x": "model"}, {"inp": 2, "out": 2}),
    ("global [i, j] => read A[i,j], reduce(+) s[j]", ("batch", "heads"),
     {"batch": "data", "heads": "model"}, {"A": 2, "s": 1}),
    ("global i => read A[i+1], read B[2*i], write C[i]", ("batch",),
     {"batch": "data"}, {"A": 1, "B": 1, "C": 1}),
    ("global i => write D[i,i]", ("batch",), {"batch": "data"}, {"D": 2}),
    ("global [i, j] => write C[i,j]", ("batch", "heads"),
     {"batch": "data", "heads": None}, {"C": 2}),
    ("global [i, j] => read A[i,:], read B[:,j], write C[i,j]", ("i", "j"),
     {"i": "data", "j": "model"}, {"A": 2, "B": 2, "C": 2}),
], ids=["stencil", "reduction", "offset_scaled", "repeated", "unmapped",
        "matmul"])
def test_derive_rules_from_plan_matches_the_reference(case):
    ann, names, mesh_of, array_ranks = case
    kw = dict(grid_axis_names=names, grid_axis_mesh=mesh_of,
              array_ranks=array_ranks)
    got = TS.derive_rules_from_plan(ann, **kw)
    want = RS.derive_rules_from_plan(ann, **kw)
    assert got == {k: spec_from_reference(v) for k, v in want.items()}
    if "inp" in got:  # the stencil's halo read replicates
        assert got == {"inp": (None, None), "out": ("data", "model")}
    if "B" in got and "C" in got and len(got["C"]) == 2 and "A" in got:
        assert got == {"A": ("data", None), "B": (None, "model"),
                       "C": ("data", "model")}


def test_spec_dedupes_a_repeated_mesh_axis_left_to_right():
    for mod in (TS, RS):
        r = mod.ShardingRules.of(batch=("pod", "data"),
                                 zero1=("data", "model"))
        # an entry of one mesh axis is its name, as PartitionSpec keeps it
        assert spec_from_reference(r.spec(("batch", "zero1"))) == \
            (("pod", "data"), "model")
        assert spec_from_reference(r.spec(("zero1", "batch"))) == \
            (("data", "model"), "pod")
        r = mod.ShardingRules.of(a=("data",), b=("data",))
        assert spec_from_reference(r.spec(("a", "b"))) == ("data", None)
    r = TS.ShardingRules.of(x="data")
    assert r.updated(y="model").get("y") == "model" and r.get("y") is None
    assert repr(r.updated(y="model")) == repr(
        RS.ShardingRules.of(x="data").updated(y="model"))


_LOGICAL = ["batch", "seq", "d_model", "heads", "kv_heads", "kv_seq",
            "d_ff", "vocab", "experts", "zero1", None]


@given(leaves=st.lists(st.lists(st.sampled_from(_LOGICAL), min_size=0,
                                max_size=4).map(tuple),
                       min_size=1, max_size=6),
       split=st.integers(0, 6), tp=st.booleans())
@settings(max_examples=100, deadline=None)
def test_tree_specs_equal_the_reference(leaves, split, tp):
    tree = {"nested": {f"k{i}": leaf for i, leaf in enumerate(leaves[:split])},
            "flat": list(leaves[split:]), "none": None, "step": ()}
    got = TS.tree_specs(TS.tp_rules() if tp else TS.dp_rules(), tree)
    want = RS.tree_specs(RS.tp_rules() if tp else RS.dp_rules(), tree)
    assert got == _ref_tree(want)
    assert got["none"] is None and got["step"] == ()
    for axes, spec in zip(leaves[split:], got["flat"]):
        assert len(spec) == len(axes)


MESHES = [((4, 1), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((2, 2), ("pod", "data")), ((3, 4), ("data", "model"))]


def _fake_mesh(shape, axes):
    """What the reference's ``rules_for`` reads of a mesh: its axis names
    and its devices' shape (not a ``Mesh``, so no mesh is attached)."""
    return types.SimpleNamespace(axis_names=axes, devices=np.empty(shape))


@pytest.mark.parametrize("arch", ARCHS)
def test_rules_for_every_config_matches_the_reference(arch):
    tcfg, rcfg = get_config(arch), r_config(arch)
    for shape, axes in MESHES:
        sizes = dict(zip(axes, shape))
        for flavor in ("tp", "dp"):
            for gb in (None, 1, 8, 96):
                for seq in (False, True):
                    got = TR.rules_for(tcfg, sizes, flavor, global_batch=gb,
                                       shard_seq=seq)
                    want = RR.rules_for(rcfg, _fake_mesh(shape, axes),
                                        flavor, global_batch=gb,
                                        shard_seq=seq)
                    assert got.table == want.table, (shape, flavor, gb)
                    assert got.mesh is None
        for gb in (1, 2, 6, 64):
            assert TR.fit_batch_axes(sizes, gb, axes) == \
                RR.fit_batch_axes(sizes, gb, axes)
        assert data_axes_of(sizes) == tuple(a for a in axes if a != "model")


def _ref_leaf(tree, name: str):
    """The reference spec of the port's parameter ``name``: stacked layers
    indexed away (their leading entry dropped), lists by index."""
    node, stacked = tree, False
    for part in name.split("."):
        if part.isdigit():
            if isinstance(node, list):
                node = node[int(part)]
            else:
                stacked = True
            continue
        node = node[part]
    spec = spec_from_reference(node)
    return spec[1:] if stacked else spec


@pytest.mark.parametrize("arch", ARCHS)
def test_train_state_specs_match_the_reference(arch):
    tcfg, rcfg = get_config(arch), r_config(arch)
    for shape, axes in MESHES[:3]:
        sizes = dict(zip(axes, shape))
        for flavor in ("tp", "dp"):
            t_rules = TR.rules_for(tcfg, sizes, flavor)
            r_rules = RR.rules_for(rcfg, _fake_mesh(shape, axes), flavor)
            for zero1 in (True, False):
                got = train_state_specs(tcfg, t_rules, zero1)
                want = r_train.train_state_specs(rcfg, r_rules, zero1)
                assert got.opt.step == spec_from_reference(want.opt.step)
                for name, spec in got.params.items():
                    assert spec == _ref_leaf(want.params, name), name
                for tree in ("master", "mu", "nu"):
                    for name, spec in getattr(got.opt, tree).items():
                        assert spec == _ref_leaf(getattr(want.opt, tree),
                                                 name), (tree, name)


def test_constrain_is_the_identity_unless_the_model_axis_is_split():
    """``constrain`` never moves data.  On a model axis of more than one
    rank it checks that a split dimension is the rank's share, for every
    family's rules (each has tensor-parallel layers)."""
    x = torch.ones(4, 4)
    assert TS.constrain(x, None, ("batch", "d_model")) is x
    assert TS.constrain(x, TS.tp_rules(), ("batch", "d_model")) is x
    rules = TS.tp_rules(data=("data",))
    assert TS.constrain(x, rules.with_mesh({"data": 4, "model": 1}),
                        ("batch", "d_model")) is x
    split = rules.with_mesh({"data": 2, "model": 2})
    for arch in ("phi3-mini-3.8b", "granite-moe-1b-a400m", "rwkv6-3b",
                 "recurrentgemma-2b", "whisper-medium"):
        r = TR.rules_for(get_smoke_config(arch), {"data": 2, "model": 2},
                         "tp").with_mesh({"data": 2, "model": 2})
        assert TS.constrain(x, r, ("batch", "d_model")) is x
        assert TS.constrain(x, r, ("batch", "heads"), (None, 8)) is x
        with pytest.raises(ValueError, match="share"):
            # a layer that forgot to split: the whole 4 of 4 columns
            TS.constrain(x, r, ("batch", "heads"), (None, 4))
        # the batch alone over a model axis (dp_rules) is data
        # parallelism: nothing is checked
        dp = TR.rules_for(get_smoke_config(arch), {"data": 2, "model": 2},
                          "dp").with_mesh({"data": 2, "model": 2})
        assert TS.constrain(x, dp, ("batch", "heads"), (None, 4)) is x
    assert TS.constrain(x, split, ("batch", "heads"), (None, 8)) is x


def test_spec_from_reference():
    assert spec_from_reference(P("data", None)) == ("data", None)
    assert spec_from_reference(P()) == ()
    assert spec_from_reference(P(("pod", "data"), "model")) == \
        (("pod", "data"), "model")
    assert spec_from_reference(None) is None


# -- decode attention's empty row ---------------------------------------------


def test_a_row_with_no_valid_key_gives_zeros_and_the_empty_lse():
    """``kv_len`` 0 (a rank's shard past a short row): zeros and lse -1e30,
    as the CUDA kernel gives (``csrc/decode_attention.cu``); the other rows
    are untouched."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(3, 4, 16, generator=g)
    k = torch.randn(3, 2, 10, 16, generator=g)
    v = torch.randn(3, 2, 10, 16, generator=g)
    kv_len = torch.tensor([0, 10, 3])
    out, lse = decode_attention_ref(q, k, v, kv_len=kv_len, with_lse=True)
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    assert bool((lse[0] == EMPTY_LSE).all()) and EMPTY_LSE == -1e30
    assert bool(torch.isfinite(out).all() and torch.isfinite(lse).all())
    for row in (1, 2):
        o, s = decode_attention_ref(q[row:row + 1], k[row:row + 1],
                                    v[row:row + 1], kv_len=kv_len[row:row + 1],
                                    with_lse=True)
        assert torch.equal(o, out[row:row + 1])
        assert torch.equal(s, lse[row:row + 1])


# -- the collectives, against the reference -----------------------------------

N = 4
SHARD = 12  # cache positions a rank holds in the flash-decode combine


def _inputs() -> dict:
    rng = np.random.default_rng(0)
    x = rng.standard_normal((16, 64)).astype(np.float32)
    w = rng.standard_normal((64, 32)).astype(np.float32)
    b, hq, hkv, d = 3, 4, 2, 16
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, N * SHARD, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, N * SHARD, d)).astype(np.float32)
    # row 1 ends in rank 1's shard, row 2 holds one key: ranks 1-3 empty
    kv_len = np.array([N * SHARD, SHARD + 1, 1], np.int32)
    outs, lses = [], []
    for r in range(N):
        lo = r * SHARD
        o, s = decode_attention_ref(
            torch.from_numpy(q), torch.from_numpy(k[:, :, lo:lo + SHARD]),
            torch.from_numpy(v[:, :, lo:lo + SHARD]),
            kv_len=torch.from_numpy(np.clip(kv_len - lo, 0, SHARD)),
            with_lse=True)
        outs.append(o.numpy())
        lses.append(s.numpy())
    return {
        # distinct values on every rank, so that a wrong roll shows
        "two_phase": rng.standard_normal((N, 8, 3)).astype(np.float32),
        "rotate": rng.standard_normal((N, 5, 3)).astype(np.float32),
        "integers": rng.integers(-1000, 1000, (N, 8, 5)).astype(np.float32),
        "x": x, "w": w,
        "g": rng.standard_normal((N, 64)).astype(np.float32),
        "grads": rng.standard_normal((N, 8, 4)).astype(np.float32),
        "q": q, "k": k, "v": v, "kv_len": kv_len,
        "part_out": np.stack(outs), "part_lse": np.stack(lses),
    }


REFERENCE = r"""
import numpy as np, jax, jax.numpy as jnp
from functools import partial
from jax.sharding import PartitionSpec as P
from repro.core.launch import shard_map
from repro.dist.collectives import (
    ring_allreduce, ring_allgather_matmul, hierarchical_grad_allreduce)
from repro.models.attention import combine_decode_partials
from repro.optim.compression import compressed_psum

inp = dict(np.load(PATH_IN))
ring = jax.make_mesh((4,), ("data",),
                     axis_types=(jax.sharding.AxisType.Auto,))
def per_rank(fn):
    return shard_map(fn, mesh=ring, in_specs=P("data"), out_specs=P("data"),
                     check_rep=False)
out = {}
for key in ("two_phase", "rotate", "integers"):
    a = inp[key]
    got = per_rank(lambda x: ring_allreduce(x, "data"))(
        jnp.asarray(a.reshape((-1,) + a.shape[2:])))
    out[key] = np.asarray(got).reshape(a.shape)
mm = shard_map(partial(ring_allgather_matmul, axis_name="data"), mesh=ring,
               in_specs=(P(None, "data"), P("data", None)), out_specs=P(),
               check_rep=False)
out["matmul"] = np.asarray(mm(jnp.asarray(inp["x"]), jnp.asarray(inp["w"])))
def comp(g):
    res, _ = compressed_psum({"g": g[0]}, "data", None)
    return res["g"][None]
out["compressed"] = np.asarray(per_rank(comp)(jnp.asarray(inp["g"])))
def comb(o, s):
    return combine_decode_partials(o[0], s[0], "data")[None]
cm = shard_map(comb, mesh=ring, in_specs=(P("data"), P("data")),
               out_specs=P("data"), check_rep=False)
out["combined"] = np.asarray(cm(jnp.asarray(inp["part_out"]),
                                jnp.asarray(inp["part_lse"])))
mesh = jax.make_mesh((2, 2), ("pod", "data"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
g = inp["grads"]
def hier(x):
    return hierarchical_grad_allreduce({"w": x[0]}, ("data",), ("pod",))[
        "w"][None]
def flat(x):
    return jax.lax.psum(x[0], ("data", "pod"))[None]
for name, fn in (("hier", hier), ("flat", flat)):
    f = shard_map(fn, mesh=mesh, in_specs=P(("pod", "data")),
                  out_specs=P(("pod", "data")), check_rep=False)
    out[name] = np.asarray(f(jnp.asarray(g)))
np.savez(PATH_OUT, **out)
print("REFERENCE-OK")
"""


@pytest.fixture(scope="module")
def collective_runs(tmp_path_factory):
    """The reference's run (a subprocess on 4 fake devices) and the port's
    (4 gloo ranks), side by side on the same inputs."""
    tmp = tmp_path_factory.mktemp("collectives")
    inputs = _inputs()
    np.savez(tmp / "in.npz", **inputs)
    code = REFERENCE.replace("PATH_IN", repr(str(tmp / "in.npz"))) \
        .replace("PATH_OUT", repr(str(tmp / "out.npz")))
    with _torch_dist_ranks.beside(run_with_devices, code, n_devices=N,
                                  timeout=300) as ref:
        port = ranks.spawn(_torch_dist_ranks.collectives, N, backend="gloo",
                           device="cpu", init_dir=str(tmp / "rdv"),
                           args=(inputs,), timeout=RANKS_TIMEOUT)
    assert "REFERENCE-OK" in ref["result"]
    return inputs, dict(np.load(tmp / "out.npz")), port


@pytest.mark.parametrize("key", ["two_phase", "rotate", "integers"])
def test_ring_allreduce_matches_the_reference(collective_runs, key):
    inputs, ref, port = collective_runs
    want = inputs[key].sum(axis=0)
    for r, out in enumerate(port):
        if key == "integers":  # integer values: every order is exact
            np.testing.assert_array_equal(out[key], want)
            np.testing.assert_array_equal(out[key], ref[key][r])
        else:
            np.testing.assert_allclose(out[key], ref[key][r], rtol=1e-6,
                                       atol=1e-6)
            np.testing.assert_allclose(out[key], want, rtol=1e-5, atol=1e-5)


def test_ring_allgather_matmul_matches_x_at_w(collective_runs):
    inputs, ref, port = collective_runs
    want = inputs["x"] @ inputs["w"]
    for out in port:
        np.testing.assert_allclose(out["matmul"], want, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(out["matmul"], ref["matmul"], rtol=1e-4,
                                   atol=1e-4)


def test_hierarchical_allreduce_equals_a_flat_psum(collective_runs):
    inputs, ref, port = collective_runs
    want = inputs["grads"].sum(axis=0)
    for r, out in enumerate(port):
        np.testing.assert_allclose(out["hier"], out["flat"], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(out["hier"], ref["hier"][r], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(out["flat"], ref["flat"][r], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(out["hier"], want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(out["hier_b"], want[0], rtol=1e-5,
                                   atol=1e-5)


def test_compressed_psum_matches_the_reference_and_bounds_the_error(
        collective_runs):
    inputs, ref, port = collective_runs
    g = inputs["g"]
    scale = np.abs(g).max() / 127
    for r, out in enumerate(port):
        assert out["no_feedback"]
        np.testing.assert_allclose(out["compressed"], ref["compressed"][r],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(out["compressed"], g.sum(axis=0),
                                   atol=scale * N * 1.01 + 1e-5)


def test_flash_decode_combine_gives_an_empty_shard_no_weight(
        collective_runs):
    """Three ranks hold no valid key of row 2 (kv_len 1) and two none of
    row 1: their zeros and lse -1e30 get weight 0, and the combine equals
    attention over the whole cache and the reference's combine."""
    inputs, ref, port = collective_runs
    assert (inputs["part_lse"][1:, 2] == EMPTY_LSE).all()
    assert (inputs["part_lse"][2:, 1] == EMPTY_LSE).all()
    whole = decode_attention_ref(
        *(torch.from_numpy(inputs[k]) for k in ("q", "k", "v")),
        kv_len=torch.from_numpy(inputs["kv_len"])).numpy()
    for r, out in enumerate(port):
        assert np.isfinite(out["combined"]).all()
        np.testing.assert_allclose(out["combined"], whole, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(out["combined"], ref["combined"][r],
                                   rtol=1e-5, atol=1e-5)
        assert out["staged"] == 0  # CPU tensors: nothing staged


def test_ranks_resolve_axes_and_permutations(collective_runs):
    _, _, port = collective_runs
    for r, out in enumerate(port):
        assert out["rank"] == r and out["index"] == r
        np.testing.assert_array_equal(out["gather"], np.arange(N)[:, None])
        # (0 -> 2), (2 -> 0), (1 -> 3); rank 1 receives nothing: zeros
        want = {0: 2.0, 1: 0.0, 2: 0.0, 3: 1.0}[r]
        assert float(out["perm"][0]) == want
        assert out["coords"] == (r // 2, r % 2, r)
        assert out["mesh_ranks"] == [[0, 1], [2, 3]]


def test_collectives_emit_dist_spans(collective_runs):
    _, _, port = collective_runs
    events = port[0]["events"]
    names = [e[0] for e in events]
    assert names.count("collective:ring_allreduce") >= 4
    assert "collective:ring_allgather_matmul" in names
    assert "collective:hierarchical_grad_allreduce" in names
    for name, stream, cat, args in events:
        assert stream == "dist" and cat == "dist", name
    ring = [a for n, _, _, a in events if n == "collective:ring_allreduce"]
    assert ring[0] == {"axis": "data", "n": N, "size": 8 * 3}
    hier = [a for n, _, _, a in events
            if n == "collective:hierarchical_grad_allreduce"]
    assert hier == [{"intra": "data", "inter": "pod", "leaves": 2}]


def test_set_tracer_returns_the_previous_and_none_restores_null():
    assert collectives._TRACER is NULL_TRACER
    tracer = Tracer()
    prev = set_tracer(tracer)
    try:
        out = collectives.hierarchical_grad_allreduce(
            {"w": torch.ones(2), "b": torch.zeros(3)}, (), ())
    finally:
        restored = set_tracer(prev)
    assert restored is tracer and collectives._TRACER is NULL_TRACER
    assert torch.equal(out["w"], torch.ones(2))
    spans = [e for e in tracer.events
             if e["name"] == "collective:hierarchical_grad_allreduce"]
    assert spans and spans[0]["args"]["leaves"] == 2
    set_tracer(Tracer())
    set_tracer(None)
    assert collectives._TRACER is NULL_TRACER


def test_spawn_needs_a_card_unless_told_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ranks.spawn(_torch_dist_ranks.collectives, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ranks.rank_device(None, 0)
    assert ranks.rank_device("cpu", 3) == torch.device("cpu")
    with pytest.raises(RuntimeError, match="no current mesh"):
        ranks.axis_size("data")

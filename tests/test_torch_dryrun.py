"""The port's dry run and its tools against the reference's, on the CPU.

``utils.roofline`` (the reference's numbers given its constants; the H100
defaults), ``configs.shapes`` (every shape, every arch's applicability,
the inputs' shapes and dtypes), ``launch.mesh.make_production_mesh``'s
geometry, the recording mesh of ``dist.ranks`` (a real tensor under it
and a meta tensor outside it raise), ``model_flops_for`` for every arch
and shape, the counterpart of ``tests/test_dryrun_small.py`` (smoke
configs on a ``{data: 2, model: 4}`` recording mesh), the scans the dry
run sets for its cells, a production cell through the CLI (its roofline's
memory term from the least bytes), and ``examples/coclustering.py``'s counterpart against
the reference's iteration.  The recorded collectives of a train step equal
a real gloo run's in ``tests/test_torch_tp.py``, whose ranks run it; those
of a decode step whose cache is split by sequence (gemma-2b's smoke config
under ``shard_seq``) a gloo run's here.
"""

from __future__ import annotations

import collections

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_config
from repro.configs import shapes as r_shapes
from repro.kernels.coclustering.ref import (
    coclustering_iteration_ref as r_cocluster,
)
from repro.models import api as r_api
from repro.utils import roofline as r_roofline
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.configs import shapes
from repro_torch.dist import ranks
from repro_torch.examples import coclustering
from repro_torch.kernels import common
from repro_torch.launch import dryrun
from repro_torch.kernels.rg_lru.kernel import rg_lru_route
from repro_torch.kernels.rg_lru.ref import rg_lru_chunked_ref, rg_lru_ref
from repro_torch.kernels.rwkv6.kernel import wkv6_route
from repro_torch.kernels.rwkv6.ref import wkv6_chunked_ref, wkv6_ref
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import api
from repro_torch.models import rglru as model_rglru
from repro_torch.models import rwkv as model_rwkv
from repro_torch.utils import roofline
from repro_torch.utils.hlo_analysis import collective_stats
from repro_torch.launch.rules import rules_for

import _torch_dist_ranks

DTYPES = {jnp.dtype(jnp.int32): torch.int32,
          jnp.dtype(jnp.float32): torch.float32,
          jnp.dtype(jnp.bfloat16): torch.bfloat16}


@pytest.mark.parametrize("case", [
    dict(flops=3e15, bytes_accessed=2e12, collective_bytes=5e9),
    dict(flops=1e12, bytes_accessed=8e12, collective_bytes=1e9,
         model_flops=6e11),
    dict(flops=2e14, bytes_accessed=1e11, collective_bytes=9e11, chips=16,
         per_device=False, model_flops=1e14),
    dict(flops=0.0, bytes_accessed=0.0, collective_bytes=0.0),
])
def test_roofline_equals_the_references_given_its_constants(case):
    args = [case.pop(k) for k in ("flops", "bytes_accessed",
                                  "collective_bytes")]
    consts = dict(peak_flops=r_roofline.PEAK_FLOPS, hbm_bw=r_roofline.HBM_BW,
                  link_bw=r_roofline.ICI_BW)
    want = r_roofline.roofline(*args, **case, **consts)
    got = roofline.roofline(*args, **case, **consts)
    w, g = want.to_dict(), got.to_dict()
    assert list(g) == list(w)
    for key in w:
        if isinstance(w[key], str):
            assert g[key] == w[key]
        else:
            assert g[key] == pytest.approx(w[key], rel=1e-12, abs=0), key
    assert got.bound_time_s == want.bound_time_s
    assert [f.name for f in roofline.dataclasses.fields(got)] == \
        [f.name for f in r_roofline.dataclasses.fields(want)]


def test_roofline_defaults_are_the_h100s():
    assert roofline.PEAK_FLOPS == common.H100_SXM_BF16_FLOPS == 989e12
    assert roofline.HBM_BW == common.H100_SXM_HBM_BYTES_PER_S == 3.35e12
    assert roofline.NVLINK_BW == 450e9
    t = roofline.roofline(989e12, 3.35e12, 450e9, model_flops=989e12 / 2)
    assert (t.compute_s, t.memory_s, t.collective_s) == (1.0, 1.0, 1.0)
    assert t.roofline_fraction == pytest.approx(0.5)
    # the fraction divides by the peak the roofline was made with
    half = roofline.roofline(1e12, 0.0, 0.0, model_flops=1e12,
                             peak_flops=2e12)
    assert half.roofline_fraction == pytest.approx(1.0)


def test_shapes_match_the_reference():
    assert shapes.SHAPE_NAMES == r_shapes.SHAPE_NAMES
    for name in shapes.SHAPE_NAMES:
        assert shapes.SHAPES[name].__dict__ == r_shapes.SHAPES[name].__dict__
        assert shapes.decode_cache_len(name) == r_shapes.decode_cache_len(name)
    for arch in ARCHS:
        cfg, rcfg = get_config(arch), r_config(arch)
        for name in shapes.SHAPE_NAMES:
            assert shapes.applicable(cfg, name) == \
                r_shapes.applicable(rcfg, name)
            got = shapes.input_specs(cfg, name)
            want = r_shapes.input_specs(rcfg, name)
            assert list(got) == list(want)
            for key, spec in want.items():
                assert tuple(got[key].shape) == spec.shape, (arch, name, key)
                assert got[key].dtype == DTYPES[jnp.dtype(spec.dtype)]
                assert got[key].device.type == "meta"


def test_model_flops_match_the_reference_for_every_cell():
    for arch in ARCHS:
        cfg, rcfg = get_config(arch), r_config(arch)
        for name in shapes.SHAPE_NAMES:
            spec = shapes.SHAPES[name]
            assert api.model_flops_for(
                cfg, spec.kind, spec.global_batch, spec.seq_len) == \
                r_api.model_flops_for(rcfg, spec.kind, spec.global_batch,
                                      spec.seq_len), (arch, name)


def test_production_mesh_geometry():
    assert make_production_mesh() == {"data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True) == {"pod": 2, "data": 16,
                                                    "model": 16}
    assert list(make_production_mesh(multi_pod=True)) == ["pod", "data",
                                                          "model"]


def test_the_recording_mesh_records_and_refuses_real_tensors():
    x = torch.empty(3, 5, device="meta")
    with ranks.recording({"data": 2, "model": 4}, {"model": 3}) as rec:
        assert ranks.axis_index("model") == 3
        assert ranks.axis_size(("data", "model")) == 8
        assert ranks.psum(x, ("data", "model")).shape == (3, 5)
        assert ranks.all_gather(x, "model").shape == (4, 3, 5)
        assert ranks.pmax(x, "data").device.type == "meta"
        assert ranks.ppermute(x, "model", [(3, 0), (0, 1)]).shape == (3, 5)
        # index 3 sends nothing here, so records nothing
        ranks.ppermute(x, "model", [(0, 1)])
        with pytest.raises(RuntimeError, match="meta"):
            ranks.psum(torch.ones(2), "model")
    assert rec.records == [("all-reduce", "data", 60, 60),
                           ("all-reduce", "model", 60, 60),
                           ("all-gather", "model", 60, 240),
                           ("all-reduce", "data", 60, 60),
                           ("collective-permute", "model", 60, 60)]
    stats = collective_stats(rec.records)
    assert stats.counts == {"all-reduce": 3, "all-gather": 1,
                            "collective-permute": 1}
    assert stats.total_operand_bytes == 300
    assert stats.summary()["output_bytes"]["all-gather"] == 240
    with ranks.use_mesh({"data": 2}), pytest.raises(RuntimeError,
                                                    match="recording"):
        ranks.psum(x, "data")


SMALL = ("phi3-mini-3.8b", "granite-moe-1b-a400m", "rwkv6-3b")


@pytest.mark.parametrize("arch", SMALL)
def test_small_mesh_train_and_decode_on_the_meta_device(arch):
    """``tests/test_dryrun_small.py``'s cells: each smoke config scaled as
    there, on a ``{data: 2, model: 4}`` recording mesh, a train step of 8
    x 32 tokens and a decode step against a 64-position cache, under
    ``tp``: FLOPs counted, and collectives where the reference's has
    them."""
    cfg = get_smoke_config(arch).scaled(
        d_model=64, d_ff=128 if arch != "granite-moe-1b-a400m" else 32)
    mesh = {"data": 2, "model": 4}
    flavor = "tp"
    train = dryrun.cell_metrics(cfg, shapes.ShapeSpec("t", 32, 8, "train"),
                                mesh, flavor)
    assert train["flops"] > 0 and train["bytes_accessed"] > 0
    assert train["collective_bytes"] > 0
    assert train["collectives"]["counts"]["all-reduce"] > 0
    assert train["memory"]["params_bytes"] > 0
    assert train["memory"]["opt_bytes"] > 0
    decode = dryrun.cell_metrics(cfg, shapes.ShapeSpec("d", 64, 8, "decode"),
                                 mesh, flavor)
    assert decode["flops"] > 0 and decode["memory"]["cache_bytes"] > 0
    if flavor == "tp":
        # the heads are split 4 ways: a rank holds its share of the weights
        assert train["memory"]["params_bytes"] < \
            sum(p.numel() * p.element_size()
                for p in api.param_shapes(cfg).parameters())
        assert "reduce_from_model" in train["spans"]


#: a granite-moe-1b smoke cell's collectives on a ``{data: 2, model: 4}``
#: recording mesh by (op, axis), ``test_small_mesh_...``'s widths: a
#: serving step sends only the model axis's (the two ``psum_batch``
#: all-reduces of each MoE layer's load statistics, 4 over 2 layers, went
#: when ``moe_mlp`` began to reduce them in training only); a train step
#: keeps them
MOE_CELL_COLLECTIVES = {
    "train": {("all-reduce", "model"): 20, ("all-gather", "model"): 4,
              ("all-reduce", "data"): 29, ("all-gather", "data"): 22},
    "prefill": {("all-reduce", "model"): 5, ("all-gather", "model"): 5},
    "decode": {("all-reduce", "model"): 5, ("all-gather", "model"): 5}}


@pytest.mark.parametrize("kind", list(MOE_CELL_COLLECTIVES))
def test_moe_cells_reduce_over_the_data_axis_only_in_training(kind):
    """The dry run of a granite-moe-1b cell over a data axis of 2: every
    collective its step sends, counted by op and axis."""
    cfg = get_smoke_config("granite-moe-1b-a400m").scaled(d_model=64,
                                                          d_ff=32)
    seq = 64 if kind == "decode" else 32
    m = dryrun.cell_metrics(cfg, shapes.ShapeSpec("m", seq, 8, kind),
                            {"data": 2, "model": 4}, "tp")
    got = collections.Counter((op, axis) for op, axis, _, _ in m["records"])
    assert dict(got) == MOE_CELL_COLLECTIVES[kind]


@pytest.mark.parametrize("t", [16, 256])
def test_the_dry_run_sets_each_scan_to_its_kernels_route(t):
    """Inside ``plain_scans`` the models' plain scans are the plain form of
    the route each kernel would take (the chunked scan from route
    ``"chunk"``'s T on, the step loop below it); outside it they are the
    step loops whatever the device."""
    g = torch.Generator().manual_seed(0)
    r, k, v = (torch.randn(1, 2, t, 8, generator=g) for _ in range(3))
    w = torch.rand(1, 2, t, 8, generator=g) * 0.5 + 0.5
    u = torch.randn(2, 8, generator=g)
    log_a = -torch.rand(1, t, 16, generator=g)
    gx = torch.randn(1, t, 16, generator=g)
    assert model_rwkv.wkv6_ref is wkv6_ref
    assert model_rglru.rg_lru_ref is rg_lru_ref
    with dryrun.plain_scans():
        got_w = model_rwkv.wkv6_ref(r, k, v, w, u, return_state=True)
        got_g = model_rglru.rg_lru_ref(log_a, gx, None, return_state=True)
    assert model_rwkv.wkv6_ref is wkv6_ref
    assert model_rglru.rg_lru_ref is rg_lru_ref
    chunk = t >= 256
    assert (wkv6_route(r, v) == "chunk") == chunk
    assert (rg_lru_route(gx) == "chunk") == chunk
    want_w = (wkv6_chunked_ref if chunk else wkv6_ref)(r, k, v, w, u,
                                                       return_state=True)
    want_g = (rg_lru_chunked_ref if chunk else rg_lru_ref)(
        log_a, gx, None, return_state=True)
    for got, want in zip(got_w + got_g, want_w + want_g):
        assert torch.equal(got, want)


def test_cells_list_runs_skips_and_queued_items():
    """Every cell the reference runs, runs: under ``tp`` on (16, 16) 32
    RUN and the reference's 8 SKIP (``long_500k`` for full attention),
    none queued, the decode cells of the attention families among the runs
    (under ``shard_seq``, as the reference's)."""
    mesh = make_production_mesh()
    status = {(a, s): dryrun.cell_status(get_config(a), s, mesh, "tp")
              for a in ARCHS for s in shapes.SHAPE_NAMES}
    assert status["phi3-mini-3.8b", "train_4k"] == ("RUN", "")
    assert status["granite-moe-3b-a800m", "prefill_32k"] == ("RUN", "")
    assert status["phi3-mini-3.8b", "long_500k"][0] == "SKIP"
    for arch in ARCHS:  # every family's decode cell runs
        assert status[arch, "decode_32k"] == ("RUN", "")
        assert dryrun._shard_seq(get_config(arch), "decode", "tp") == (
            get_config(arch).family not in ("rwkv", "hybrid"))
    for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        assert status["rwkv6-3b", shape] == ("RUN", "")
        assert status["recurrentgemma-2b", shape] == ("RUN", "")
    assert status["whisper-medium", "train_4k"] == ("RUN", "")
    assert status["whisper-medium", "prefill_32k"] == ("RUN", "")
    tally = collections.Counter(v[0] for v in status.values())
    assert tally == {"RUN": 32, "SKIP": 8}
    for a in ARCHS:  # under dp every family runs
        for s in shapes.SHAPE_NAMES:
            got = dryrun.cell_status(get_config(a), s, mesh, "dp")[0]
            assert got == ("RUN" if r_shapes.applicable(r_config(a), s)[0]
                           else "SKIP")


@pytest.mark.parametrize("arch,split", [("gemma-2b", True),
                                        ("qwen1.5-32b", True),
                                        ("phi3-mini-3.8b", False),
                                        ("whisper-medium", False)])
def test_a_production_decode_cell_splits_the_sequence_where_its_spec_does(
        arch, split):
    """At (16, 16) under ``shard_seq``, gemma-2b's one KV head and
    qwen1.5-32b's 40 leave "model" to the cache's sequence: a rank holds
    2048 of its 32768 positions, and each layer's step records the
    combine (three all-reduces in a ``combine_decode_partials`` span);
    phi3-mini's 32 KV heads and whisper-medium's 16 take it, and the
    sequence stays whole, with no combine."""
    cfg = get_config(arch)
    mesh = {"data": 16, "model": 16}
    spec = shapes.SHAPES["decode_32k"]
    m = dryrun.cell_metrics(cfg, spec, mesh, "tp", shard_seq=True)
    with ranks.recording(mesh) as rec:
        rules = rules_for(cfg, rec, "tp", global_batch=spec.global_batch,
                          shard_seq=True)
        state = api.init_decode_state(cfg, spec.global_batch // 16,
                                      spec.seq_len, "meta", rules)
    leaf = state["self_k" if cfg.family == "encdec"
                 else "k_q" if cfg.kv_quant else "k"]
    assert leaf.shape[3] == spec.seq_len // (16 if split else 1)
    assert m["memory"]["cache_bytes"] == sum(
        x.numel() * x.element_size() for x in state.values())
    layers = cfg.n_layers
    if split:
        assert m["spans"]["combine_decode_partials"]["calls"] == layers
    else:
        assert "combine_decode_partials" not in m["spans"]


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)],
                         ids=lambda s: "x".join(map(str, s)))
def test_a_seq_split_decode_cell_records_the_gloo_steps_collectives(shape):
    """gemma-2b's smoke decode cell under ``shard_seq`` on the meta device
    (``cell_metrics``, rank 0's) records the all-reduces and all-gathers
    that a real decode step on 4 gloo ranks sent, op for op and byte for
    byte, on every rank, and the same ``collective:*`` spans (calls and
    bytes): the combine's three all-reduces a layer, q's gather, the
    attention and MLP's ``reduce_from_model``, the logits' gather."""
    cfg = get_smoke_config("gemma-2b")
    b, max_len = 4, 24
    rng = np.random.default_rng(9)
    tokens = rng.integers(0, cfg.vocab, (b, 8)).astype(np.int32)
    step = rng.integers(0, cfg.vocab, (b, 1)).astype(np.int32)
    real = ranks.spawn(_torch_dist_ranks.seq_decode_collectives, 4,
                       backend="gloo", device="cpu",
                       args=(cfg, shape, tokens, step, max_len),
                       timeout=300)
    dry = dryrun.cell_metrics(cfg, shapes.ShapeSpec("d", max_len, b,
                                                    "decode"),
                              {"data": shape[0], "model": shape[1]}, "tp",
                              shard_seq=True)
    assert dry["spans"]["combine_decode_partials"]["calls"] == cfg.n_layers
    for r in real:
        assert collections.Counter(r["records"]) == \
            collections.Counter(dry["records"])
        assert r["spans"] == dry["spans"]


def test_the_cli_lists_every_cell(capsys):
    assert dryrun.main(["--list"]) == 0
    lines = capsys.readouterr().out.splitlines()
    rows = [ln for ln in lines if ln.split()[0] in ARCHS]
    assert len(rows) == len(ARCHS) * len(shapes.SHAPE_NAMES)
    assert all(ln.split()[2].rstrip(":") in ("RUN", "SKIP")
               for ln in rows)


def test_a_production_cell_writes_the_references_keys(tmp_path, capsys):
    """granite-moe-3b's prefill at (16, 16): its 40 experts whole with d_ff
    split, 1.5 heads of query columns a rank gathered whole."""
    assert dryrun.main(["--arch", "granite-moe-3b-a800m", "--shape",
                        "prefill_32k", "--out", str(tmp_path)]) == 0
    art = json.loads((tmp_path / "granite-moe-3b-a800m__prefill_32k__pod1"
                      "__tp.json").read_text())
    for key in ("arch", "shape", "kind", "flavor", "mesh", "collectives",
                "roofline", "tokens", "memory"):
        assert key in art, key
    assert art["mesh"] == {"axes": ["data", "model"], "shape": [16, 16],
                           "chips": 256}
    assert art["tokens"] == 32 * 32768
    mem = art["memory"]
    assert mem["fits"] and mem["card_bytes"] == 85_017_493_504
    assert mem["cache_bytes"] > 0 and mem["params_bytes"] > 0
    r = art["roofline"]
    assert r["flops"] > 0 and r["collective_bytes"] > 0
    assert r["compute_s"] == pytest.approx(r["flops"] / 989e12)
    # the memory term is the least bytes, so the bound is a least time: a
    # prefill reads the params and the rank's 2 rows of int32 tokens once
    # and writes the cache once; the eager bytes stand beside it
    assert r["bytes_accessed"] == \
        mem["params_bytes"] + mem["cache_bytes"] + 2 * 32768 * 4
    assert r["memory_s"] == pytest.approx(r["bytes_accessed"] / 3.35e12)
    assert r["eager_bytes_accessed"] > r["bytes_accessed"]
    assert r["eager_memory_s"] == pytest.approx(
        r["eager_bytes_accessed"] / 3.35e12)
    assert r["bound_time_s"] == max(r["compute_s"], r["memory_s"],
                                    r["collective_s"])
    assert r["model_flops"] == pytest.approx(r_api.model_flops_for(
        r_config("granite-moe-3b-a800m"), "prefill", 32, 32768) / 256)
    assert art["collectives"]["counts"]["all-reduce"] > 0
    assert art["paths"]["attention_impl"] == "xla"
    out = capsys.readouterr().out
    assert '"PASS": 1' in out and '"processes": 1' in out


def test_coclustering_example_matches_the_reference_iteration(capsys):
    rows, cols, r, c, iters = 256, 64, 8, 6, 3
    got = coclustering.run(rows, cols, r, c, iters, "cpu")
    z, _, _, ra, ca = coclustering.planted(rows, cols, r, c)
    zj, raj, caj = jnp.asarray(z), jnp.asarray(ra), jnp.asarray(ca)
    for _ in range(iters):
        raj, caj = r_cocluster(zj, raj, caj, r, c)
    np.testing.assert_array_equal(got["rows"], np.asarray(raj))
    np.testing.assert_array_equal(got["cols"], np.asarray(caj))
    _, row_gt, col_gt, _, _ = coclustering.planted(rows, cols, r, c)
    assert got["row_purity"] == coclustering.purity(np.asarray(raj),
                                                    row_gt, r)
    assert got["col_purity"] == coclustering.purity(np.asarray(caj),
                                                    col_gt, c)
    out = capsys.readouterr().out
    assert out.count("iter ") == iters and "row purity" in out
    jax.clear_caches()

"""Sharded training (``make_train_step(cfg, rules, mesh)``) and the elastic
restore (``restore_resharded``) against the reference, on the CPU.

One train step of the gemma-2b and granite-moe-1b smoke configs from a
carried state at step 60 (the reference's state from ``jax.random.key(0)``
with moments from numpy, carried by ``train_state_from_reference``) on a
global batch of 8 x 16 tokens over a (4, 1) ``("data", "model")`` mesh,
under ``rules_for`` "tp" (the optimizer state ZeRO-1 sharded) and "dp"
(replicated): the reference's GSPMD step on 4 fake devices in one
subprocess, the port's on 4 gloo ranks, and the port's one-rank step.
Limits as for one step on one device (``tests/test_torch_train.py``): the
loss at rtol 1e-5, the gradient norm at 1e-4, every master and moment leaf
within 1e-6 + 1e-4 |x|.  A checkpoint saved by 4 ranks restores onto 2
ranks and onto 1 bit for bit.
"""

from __future__ import annotations

import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as r_smoke
from repro.optim.adamw import AdamWState as RAdamWState
from repro.train import train_loop as r_train
from repro_torch.ckpt import CheckpointManager, restore_resharded
from repro_torch.configs import get_smoke_config
from repro_torch.convert import config_from_reference, \
    train_state_from_reference
from repro_torch.dist import ranks
from repro_torch.launch.rules import rules_for
from repro_torch.train.train_loop import (
    init_train_state,
    make_train_step,
    train_state_specs,
)

from _subproc import run_with_devices
import _torch_dist_ranks

ARCHS = ["gemma-2b", "granite-moe-1b-a400m"]
FLAVORS = ["tp", "dp"]
N = 4
BATCH, SEQ = 8, 16
RANKS_TIMEOUT = 150


def _np(x):
    return x.detach().to(torch.float32).numpy()


def _with_history(state, rng, step):
    """The reference state with moments from numpy (mu of scale 1e-3, nu
    its square plus 1e-8) at ``step``, past the schedule's warm-up."""
    hist = lambda a: rng.standard_normal(a.shape).astype(np.float32) * 1e-3
    mu = jax.tree.map(lambda a: jnp.asarray(hist(a)), state.opt.master)
    nu = jax.tree.map(lambda a: jnp.asarray(hist(a) ** 2 + 1e-8),
                      state.opt.master)
    return r_train.TrainState(state.params, RAdamWState(
        jnp.asarray(step, jnp.int32), state.opt.master, mu, nu))


@functools.lru_cache(maxsize=None)
def _reference(arch):
    rcfg = r_smoke(arch)
    rng = np.random.default_rng(3)
    state = _with_history(r_train.init_train_state(jax.random.key(0), rcfg),
                          rng, 60)
    toks = rng.integers(0, rcfg.vocab, (BATCH, SEQ)).astype(np.int32)
    return rcfg, state, toks


REFERENCE = r"""
import numpy as np, jax, jax.numpy as jnp
from repro.configs import get_smoke_config
from repro.launch.rules import rules_for
from repro.train import train_loop
mesh = jax.make_mesh((4, 1), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
for arch in ARCHS:
    cfg = get_smoke_config(arch)
    tree = jax.tree.structure(train_loop.init_train_state(jax.random.key(0),
                                                          cfg))
    data = np.load(f"{DIR}/{arch}.in.npz")
    state = jax.tree.unflatten(tree, [jnp.asarray(data[f"arr_{i}"])
                                      for i in range(tree.num_leaves)])
    batch = {"tokens": jnp.asarray(data["tokens"])}
    for flavor in ("tp", "dp"):
        rules = rules_for(cfg, mesh, flavor, global_batch=BATCH)
        step = train_loop.make_train_step(cfg, rules, mesh, donate=False)
        new, m = step(state, batch)
        leaves = [np.asarray(x) for x in jax.tree.leaves(new)]
        np.savez(f"{DIR}/{arch}.{flavor}.out.npz", *leaves,
                 loss=np.asarray(m["loss"]), grad_norm=np.asarray(m["grad_norm"]),
                 lr=np.asarray(m["lr"]))
print("REFERENCE-OK")
"""


def _carried(rstate, tcfg):
    return train_state_from_reference(jax.tree.map(np.asarray, rstate), tcfg,
                                      "cpu")


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory):
    """The reference's sharded steps (one subprocess, 4 fake devices), the
    port's (4 gloo ranks) and the port's one-rank steps."""
    tmp = tmp_path_factory.mktemp("train")
    cases, single = [], {}
    for arch in ARCHS:
        rcfg, rstate, toks = _reference(arch)
        np.savez(tmp / f"{arch}.in.npz",
                 *[np.asarray(x) for x in jax.tree.leaves(rstate)],
                 tokens=toks)
        tcfg = config_from_reference(rcfg)
        tstate = _carried(rstate, tcfg)
        batch = {"tokens": torch.from_numpy(toks)}
        for flavor in FLAVORS:
            cases.append((f"{arch}/{flavor}", tcfg, flavor, tstate, batch))
        single[arch] = make_train_step(tcfg, donate=False)(tstate, batch)
    code = f"ARCHS = {ARCHS!r}\nDIR = {str(tmp)!r}\nBATCH = {BATCH}\n" \
        + REFERENCE
    with _torch_dist_ranks.beside(run_with_devices, code, n_devices=N,
                                  timeout=400) as out:
        port = ranks.spawn(_torch_dist_ranks.train_steps, N, backend="gloo",
                           device="cpu", init_dir=str(tmp / "rdv"),
                           args=(cases, (N, 1)), timeout=RANKS_TIMEOUT)
    assert "REFERENCE-OK" in out["result"]
    ref = {}
    for arch in ARCHS:
        rcfg, rstate, _ = _reference(arch)
        tree = jax.tree.structure(rstate)
        for flavor in FLAVORS:
            data = np.load(tmp / f"{arch}.{flavor}.out.npz")
            new = jax.tree.unflatten(tree, [data[f"arr_{i}"]
                                            for i in range(tree.num_leaves)])
            ref[arch, flavor] = (_carried(new, config_from_reference(rcfg)),
                                 {k: float(data[k]) for k in
                                  ("loss", "grad_norm", "lr")})
    return ref, port, single


def _close(got, want, what):
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-6,
                               err_msg=what)


@pytest.mark.parametrize("flavor", FLAVORS)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_the_reference_and_one_rank(train_runs, arch,
                                                         flavor):
    ref, port, single = train_runs
    label = f"{arch}/{flavor}"
    by_rank = [next(r for r in rank if r["label"] == label) for rank in port]
    got = by_rank[0]
    want_state, want = ref[arch, flavor]
    one_state, one = single[arch]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["loss"], float(one["loss"]), rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=1e-4)
    np.testing.assert_allclose(got["grad_norm"], float(one["grad_norm"]),
                               rtol=1e-4)
    np.testing.assert_allclose(got["lr"], want["lr"], rtol=1e-6)
    assert got["step"] == int(want_state.step) == 61
    for r in by_rank:  # every rank reports the global batch's numbers
        assert r["loss"] == got["loss"]
        assert r["grad_norm"] == got["grad_norm"]
    for tree in ("master", "mu", "nu"):
        mine = got[tree]
        theirs, one_rank = getattr(want_state.opt, tree), \
            getattr(one_state.opt, tree)
        assert list(mine) == list(theirs)
        for name in theirs:
            _close(mine[name], theirs[name], f"{label} {tree}/{name}")
            _close(mine[name], one_rank[name], f"{label} {tree}/{name}")
    for name, p in one_state.params.named_parameters():
        for r in by_rank:  # the params are the same on every rank
            assert torch.equal(r["params"][name], by_rank[0]["params"][name])
        _close(by_rank[0]["params"][name], p, f"{label} params/{name}")


@pytest.mark.parametrize("arch", ARCHS)
def test_zero1_shards_the_optimizer_state_and_dp_keeps_it_whole(train_runs,
                                                                 arch):
    _, port, single = train_runs
    one_state, _ = single[arch]
    whole = {k: tuple(v.shape) for k, v in one_state.opt.master.items()}
    for rank in port:
        tp = next(r for r in rank if r["label"] == f"{arch}/tp")
        dp = next(r for r in rank if r["label"] == f"{arch}/dp")
        assert dp["local_shapes"] == whole
        for name, shape in whole.items():
            local = tp["local_shapes"][name]
            # one axis (the zero1 one) split 4 ways, the rest whole
            split = [d for d, (a, b) in enumerate(zip(shape, local)) if a != b]
            assert len(split) == 1 and local[split[0]] * N == \
                shape[split[0]], (name, shape, local)
    # the update is elementwise and the clip uses the whole gradient's
    # norm: ZeRO-1 and replicated give the same numbers bit for bit
    tp = next(r for r in port[0] if r["label"] == f"{arch}/tp")
    dp = next(r for r in port[0] if r["label"] == f"{arch}/dp")
    for tree in ("master", "mu", "nu"):
        for name in tp[tree]:
            assert torch.equal(tp[tree][name], dp[tree][name]), name


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "rwkv6-3b",
                                  "recurrentgemma-2b", "whisper-medium",
                                  "flat-dispatch"])
def test_the_model_axis_split_and_a_flat_moe_dispatch_raise(arch):
    """A model axis of more than one rank builds a tensor-parallel step for
    every family (``tests/test_torch_tp.py`` runs them), each parameter's
    slice the rank's share under its specs; the flat MoE dispatch raises
    under a split batch, and under a split model axis (in the train step,
    and in the layer itself)."""
    if arch in ("flat-dispatch", "granite-moe-1b-a400m"):
        moe = dataclasses.replace(_torch_dist_ranks.replace_impl(
            get_smoke_config("granite-moe-1b-a400m")), moe_flat_dispatch=True)
        mesh = {"data": 4, "model": 1} if arch == "flat-dispatch" \
            else {"data": 1, "model": 4}
        flavor = "dp" if arch == "flat-dispatch" else "tp"
        with pytest.raises(NotImplementedError, match="flat MoE dispatch"):
            make_train_step(moe, rules_for(moe, mesh, flavor, global_batch=8),
                            mesh)
        if arch == "granite-moe-1b-a400m":
            from repro_torch.models import api, moe as moe_mod

            rules = rules_for(moe, mesh, "tp").with_mesh(mesh)
            params = api.init_params(torch.Generator().manual_seed(0), moe,
                                     "cpu")
            x = torch.zeros(1, 4, moe.d_model)
            with pytest.raises(NotImplementedError,
                               match="flat MoE dispatch"):
                moe_mod.moe_mlp(params.layers[0], x, moe, rules)
        return
    from repro_torch.models import api

    cfg = _torch_dist_ranks.replace_impl(get_smoke_config(arch))
    mesh = {"data": 2, "model": 2}
    rules = rules_for(cfg, mesh, "tp")
    assert make_train_step(cfg, rules, mesh) is not None
    specs = train_state_specs(cfg, rules.with_mesh(mesh)).params
    whole = dict(api.param_shapes(cfg).named_parameters())
    split = [name for name, spec in specs.items() if "model" in spec]
    assert split
    for name in split:
        assert whole[name].shape[list(specs[name]).index("model")] % 2 == 0


def test_checkpoint_saved_on_four_ranks_restores_onto_two_and_one(tmp_path):
    """The counterpart of ``tests/test_multidevice.py::
    test_elastic_reshard_across_meshes``: a ZeRO-1 state saved by 4 ranks
    (each leaf gathered whole, rank 0 writing) restores onto 2 ranks (each
    its half of every optimizer leaf) and onto 1 (whole leaves), bit for
    bit."""
    cfg = _torch_dist_ranks.replace_impl(get_smoke_config("gemma-2b"))
    state = init_train_state(torch.Generator().manual_seed(0), cfg, "cpu")
    g = torch.Generator().manual_seed(1)
    for name, m in state.opt.master.items():
        m.add_(torch.randn(m.shape, generator=g))
        state.opt.mu[name].copy_(torch.randn(m.shape, generator=g))
        state.opt.nu[name].copy_(torch.rand(m.shape, generator=g))
    state.opt.step.fill_(3)
    directory = str(tmp_path / "ckpt")
    saved = ranks.spawn(_torch_dist_ranks.save_sharded, N, backend="gloo",
                        device="cpu", init_dir=str(tmp_path / "rdv4"),
                        args=(cfg, state, directory, 3),
                        timeout=RANKS_TIMEOUT)
    assert saved[0]["shapes"]["embed"] == (cfg.vocab, cfg.d_model // N)
    assert saved[0]["files"] == ["step_00000003"]

    template = copy.deepcopy(state)
    halves = ranks.spawn(_torch_dist_ranks.restore_onto, 2, backend="gloo",
                         device="cpu", init_dir=str(tmp_path / "rdv2"),
                         args=(cfg, template, directory, (2, 1)),
                         timeout=RANKS_TIMEOUT)
    rules2 = rules_for(cfg, {"data": 2, "model": 1}, "tp")
    specs2 = train_state_specs(cfg, rules2)
    for part in halves:
        assert part["step"] == 3 and part["opt_step"] == 3
        for name, p in state.params.named_parameters():
            assert torch.equal(part["params"][name], p.detach())
        for tree in ("master", "mu", "nu"):
            for name, whole in getattr(state.opt, tree).items():
                spec = specs2.opt.master[name]
                dim = next(d for d, e in enumerate(spec) if e == "data")
                size = whole.shape[dim] // 2
                want = whole.narrow(dim, part["index"] * size, size)
                assert torch.equal(part[tree][name], want), (tree, name)

    one, meta = restore_resharded(CheckpointManager(directory), template,
                                  specs2, None)
    assert meta["step"] == 3
    for a, b in zip(_torch_dist_ranks_leaves(state),
                    _torch_dist_ranks_leaves(one)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _torch_dist_ranks_leaves(state):
    opt = state.opt
    return [p.detach() for p in state.params.parameters()] + [opt.step] + [
        t for tree in (opt.master, opt.mu, opt.nu) for t in tree.values()]


@pytest.mark.parametrize("arch", ["rwkv6-3b", "recurrentgemma-2b",
                                  "whisper-medium"])
def test_launchers_serve_and_train_over_a_mesh(arch, tmp_path):
    """``launch.serve.run_serving`` over a (1, 4) mesh and
    ``launch.train.run_training`` over (2, 2) (4 gloo ranks on the CPU,
    ``--mesh``): the engine completes every request as one device does,
    the ranks' tokens equal; the losses equal one device's at rtol 1e-5,
    and a rerun with more steps resumes from the sharded checkpoint."""
    from repro_torch.launch.serve import run_serving
    from repro_torch.launch.train import run_training

    kw = dict(smoke=True, requests=3, prompt_len=8, max_new=4, slots=2,
              device="cpu")
    one = run_serving(arch, **kw)
    over = run_serving(arch, mesh=(1, 4), **kw)
    assert over["mesh"] == [1, 4] and over["backend"] == "gloo"
    for key in ("arch", "completed", "decode_tokens", "prefill_tokens"):
        assert over[key] == one[key], key
    tkw = dict(smoke=True, batch=4, seq=16, device="cpu")
    one = run_training(arch, steps=5, **tkw)
    ckpt = str(tmp_path / "ckpt")
    over = run_training(arch, steps=3, mesh=(2, 2), ckpt_dir=ckpt,
                        ckpt_every=2, **tkw)
    assert over["mesh"] == [2, 2] and over["steps"] == 3
    np.testing.assert_allclose(over["losses"], one["losses"][:3], rtol=1e-5)
    more = run_training(arch, steps=5, mesh=(2, 2), ckpt_dir=ckpt, **tkw)
    assert more["steps"] == 5 and len(more["losses"]) == 2
    np.testing.assert_allclose(more["losses"], one["losses"][3:], rtol=1e-5)


def test_launcher_serves_the_hybrid_with_its_ring_split_by_sequence():
    """``launch/serve.py --arch recurrentgemma-2b --mesh 1,4 --shard-seq``
    (4 gloo ranks on the CPU, each with its run of 4 of the smoke ring's
    16 slots): prompts of 20 tokens, past the window, and 6 requests on 2
    slots give every rank the one-device engine's greedy tokens."""
    from repro_torch.launch import serve

    kw = dict(smoke=True, requests=6, prompt_len=20, max_new=6, slots=2,
              seed=0)
    one = serve._serve("recurrentgemma-2b", device=torch.device("cpu"), **kw)
    over = ranks.spawn(serve._serve_rank, 4, backend="gloo", device="cpu",
                       args=("recurrentgemma-2b", dict(kw, shard_seq=True),
                             (1, 4)), timeout=300)
    assert len(one["outputs"]) == 6
    for rank in over:
        assert rank["outputs"] == one["outputs"]

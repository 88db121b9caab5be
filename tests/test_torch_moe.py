"""The port's MoE family (granite-moe) against the reference's.

Parameters come from ``jax.random.key(0)`` in the reference and are carried
over through ``repro_torch.convert``; inputs come from numpy seeds.  The
reference runs on the CPU as its own tests run it (``attention_impl``
"pallas" in Pallas interpret mode, or "xla"); the port runs on CPU tensors,
where its ``"cuda"`` attention takes the plain versions.  Tolerances: 1e-4
for logits, caches and the aux loss of the f32 smoke configs (another order
of summation), 2e-3 for teacher-forced decode against the full forward, as
the reference's ``test_prefill_decode_matches_full_forward``; the dispatch
and combine pairs' backward at 1e-6 (each is a gather or a sum of at most
a few terms).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as r_smoke
from repro.models import api as r_api
from repro.models import moe as r_moe
from repro_torch.configs import get_smoke_config
from repro_torch.convert import config_from_reference, params_from_reference
from repro_torch.models import api as t_api
from repro_torch.models import moe as t_moe
from repro_torch.models.transformer import DecoderLayer

ARCHS = ["granite-moe-1b-a400m", "granite-moe-3b-a800m"]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


@functools.lru_cache(maxsize=None)
def _pair(arch, impl="pallas"):
    """(reference cfg, its params, port cfg, port params) for a smoke
    config, the port's parameters carried over from the reference's."""
    rcfg = dataclasses.replace(r_smoke(arch), attention_impl=impl)
    rparams = r_api.init_params(jax.random.key(0), rcfg)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), rparams)
    tcfg = config_from_reference(rcfg)
    return rcfg, rparams, tcfg, params_from_reference(tree, tcfg, "cpu")


def _tokens(cfg, rng, b, s):
    toks = rng.randint(0, cfg.vocab, (b, s)).astype(np.int32)
    return jnp.asarray(toks), torch.from_numpy(toks)


def _layer(rparams, i=0):
    """Layer ``i`` of the reference's stacked tree, both ways."""
    rl = jax.tree.map(lambda a: a[i], rparams["layers"])
    tl = jax.tree.map(lambda a: torch.from_numpy(np.array(a, np.float32)),
                      rl)
    return rl, DecoderLayer(tl)


# -- parameters ---------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_params_carry_over_with_counts_and_axes(arch):
    rcfg, rparams, tcfg, tparams = _pair(arch)
    assert t_api.param_count(tparams) == r_api.param_count(rparams)
    np.testing.assert_array_equal(_np(tparams.layers[1].router),
                                  np.asarray(rparams["layers"]["router"][1]))
    np.testing.assert_array_equal(
        _np(tparams.layers[0].moe["w_down"]),
        np.asarray(rparams["layers"]["moe"]["w_down"][0]))
    assert not hasattr(tparams.layers[0], "mlp")
    is_leaf = lambda x: isinstance(x, tuple)  # noqa: E731
    assert jax.tree.leaves(t_api.params_logical_axes(tcfg), is_leaf=is_leaf) \
        == jax.tree.leaves(r_api.params_logical_axes(rcfg), is_leaf=is_leaf)
    assert t_moe.layer_logical_axes(tcfg) == r_moe.layer_logical_axes(rcfg)
    assert t_api.state_logical_axes(tcfg) == r_api.state_logical_axes(rcfg)
    own = t_api.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    assert {n: tuple(p.shape) for n, p in own.named_parameters()} == \
        {n: tuple(p.shape) for n, p in tparams.named_parameters()}
    assert t_moe.AUX_LOSS_COEF == r_moe.AUX_LOSS_COEF


# -- forward passes -------------------------------------------------------------


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_logits_aux_and_loss_match(arch, impl):
    rcfg, rparams, tcfg, tparams = _pair(arch, impl)
    rt, tt = _tokens(rcfg, np.random.RandomState(30), 2, 12)
    want, _, want_aux = r_moe.forward(rparams, rt, rcfg, mode="train")
    got, cache, aux = t_moe.forward(tparams, tt, tcfg, mode="train")
    assert cache is None
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-4)
    np.testing.assert_allclose(
        float(t_api.train_loss(tparams, {"tokens": tt}, tcfg)),
        float(r_api.train_loss(rparams, {"tokens": rt}, rcfg)), rtol=1e-5)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_three_decode_steps_match(arch, impl):
    rcfg, rparams, tcfg, tparams = _pair(arch, impl)
    rng = np.random.RandomState(31)
    b, s, max_len = 2, 9, 24
    rt, tt = _tokens(rcfg, rng, b, s)
    rstate = r_api.init_decode_state(rcfg, b, max_len)
    tstate = t_api.init_decode_state(tcfg, b, max_len, "cpu")
    rlog, rstate = r_api.prefill(rparams, {"tokens": rt}, rcfg, rstate)
    tlog, tstate = t_api.prefill(tparams, {"tokens": tt}, tcfg, tstate)
    np.testing.assert_allclose(_np(tlog), _np(rlog), rtol=1e-4, atol=1e-4)
    for step in range(3):
        tok = rng.randint(0, rcfg.vocab, (b, 1)).astype(np.int32)
        rlog, rstate = r_api.decode_step(rparams, jnp.asarray(tok), rcfg,
                                         rstate)
        tlog, tstate = t_api.decode_step(tparams, torch.from_numpy(tok),
                                         tcfg, tstate)
        assert tlog.shape == (b, 1, tcfg.vocab)
        np.testing.assert_allclose(_np(tlog), _np(rlog), rtol=1e-4,
                                   atol=1e-4, err_msg=f"decode step {step}")
    assert sorted(tstate) == sorted(rstate)
    np.testing.assert_array_equal(tstate["pos"].numpy(),
                                  np.asarray(rstate["pos"]))
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tstate[name]), _np(rstate[name]),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_decode_matches_full_forward(arch):
    """The reference's ``test_prefill_decode_matches_full_forward`` on the
    port: with ``capacity_factor`` 8 no token is dropped, so a batch-1
    prefill and decode steps route as the full forward does."""
    cfg = get_smoke_config(arch).scaled(capacity_factor=8.0)
    params = t_api.init_params(torch.Generator().manual_seed(3), cfg, "cpu")
    toks = torch.from_numpy(np.random.RandomState(32)
                            .randint(0, cfg.vocab, (1, 12)).astype(np.int32))
    full, _, _ = t_moe.forward(params, toks, cfg, mode="train")
    state = t_api.init_decode_state(cfg, 1, 16, "cpu")
    _, state = t_api.prefill(params, {"tokens": toks[:, :9]}, cfg, state)
    for i in range(9, 12):
        logits, state = t_api.decode_step(params, toks[:, i:i + 1], cfg,
                                          state)
        np.testing.assert_allclose(_np(logits[0, 0]), _np(full[0, i]),
                                   rtol=2e-3, atol=2e-3)


# -- the routed MLP ---------------------------------------------------------------

#: (config changes, rows of the buffer's expert axis): the default
#: capacity, a capacity small enough that tokens drop, the flat dispatch
#: (with drops too), and virtual experts padded to a multiple
MLP_CASES = {
    "batched": ({}, 5),
    "dropping": ({"capacity_factor": 0.5}, 5),
    "flat": ({"moe_flat_dispatch": True, "capacity_factor": 0.5}, 5),
    "padded": ({"expert_pad_to": 4}, 8),
    "flat_padded": ({"moe_flat_dispatch": True, "expert_pad_to": 8}, 8),
}


@pytest.mark.parametrize("case", list(MLP_CASES))
def test_moe_mlp_matches(case):
    changes, e_buf = MLP_CASES[case]
    rcfg = dataclasses.replace(r_smoke("granite-moe-3b-a800m"), **changes)
    tcfg = config_from_reference(rcfg)
    _, rparams, _, _ = _pair("granite-moe-3b-a800m")
    rl, tl = _layer(rparams, 1)
    x = np.random.RandomState(33).randn(3, 10, rcfg.d_model) \
        .astype(np.float32)
    want, want_aux = r_moe.moe_mlp(rl, jnp.asarray(x), rcfg, None)
    got, aux = t_moe.moe_mlp(tl, torch.from_numpy(x), tcfg, None)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
    assert t_moe._experts_buffered(tcfg) == e_buf
    if rcfg.capacity_factor < 1:
        # tokens were dropped: a capacity where none is gives another result
        roomy = tcfg.scaled(capacity_factor=8.0)
        full, _ = t_moe.moe_mlp(tl, torch.from_numpy(x), roomy, None)
        assert not torch.allclose(got, full, atol=1e-3)


def test_top_k_ties_go_to_the_lower_index():
    """Router logits built to tie (columns of the router repeated): the
    experts and the output are the reference's, whose ``lax.top_k`` takes
    the lower index among equal probabilities."""
    rcfg = r_smoke("granite-moe-3b-a800m")  # 5 experts, top 2
    tcfg = config_from_reference(rcfg)
    _, rparams, _, _ = _pair("granite-moe-3b-a800m")
    rl, _ = _layer(rparams, 0)
    router = np.asarray(rl["router"], np.float32).copy()
    router[:, 2] = router[:, 4] = router[:, 1]  # experts 1, 2, 4 tie
    router[:, 3] = router[:, 0]  # and 0, 3
    rl = dict(rl, router=jnp.asarray(router))
    tl = DecoderLayer(jax.tree.map(
        lambda a: torch.from_numpy(np.array(a, np.float32)), rl))
    x = np.random.RandomState(34).randn(2, 16, rcfg.d_model) \
        .astype(np.float32)
    probs, _, idx = t_moe._route(tl, torch.from_numpy(x), tcfg)
    want_gates, want_idx = jax.lax.top_k(jnp.asarray(_np(probs)), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    # both tied groups lead somewhere; 4 never wins against 1 and 2
    chosen = set(idx.numpy().ravel().tolist())
    assert {0, 1} <= chosen and 4 not in chosen
    want, _ = r_moe.moe_mlp(rl, jnp.asarray(x), rcfg, None)
    got, _ = t_moe.moe_mlp(tl, torch.from_numpy(x), tcfg, None)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)
    # torch.topk is free to order ties otherwise: the stable sort is not
    ranked = torch.sort(probs, dim=-1, descending=True, stable=True)[1]
    np.testing.assert_array_equal(ranked[..., :2].numpy(),
                                  np.asarray(want_idx))


def _scatter_inputs(rng, b=2, n=7, d=3, e_buf=4, cap=2):
    """Expert and slot indices with repeats (a dropped token's zero lands
    on a kept token's slot), and tokens with zero rows for the dropped."""
    idx_e = rng.randint(0, e_buf, (b, n)).astype(np.int32)
    idx_c = rng.randint(0, cap, (b, n)).astype(np.int32)
    idx_e[:, 1], idx_c[:, 1] = idx_e[:, 0], idx_c[:, 0]
    tok = rng.randn(b, n, d)
    tok[:, 1] = 0.0
    return idx_e, idx_c, tok, e_buf, cap


def test_dispatch_scatter_accumulates_like_the_reference():
    idx_e, idx_c, tok, e_buf, cap = _scatter_inputs(np.random.RandomState(35))
    tok = tok.astype(np.float32)
    want = r_moe._dispatch_scatter(jnp.asarray(idx_e), jnp.asarray(idx_c),
                                   jnp.asarray(tok), e_buf, cap, None)
    ti = [torch.from_numpy(a).long() for a in (idx_e, idx_c)]
    got = t_moe._dispatch_scatter(*ti, torch.from_numpy(tok), e_buf, cap,
                                  None)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)
    # the kept token survives the dropped one's zero at its slot
    np.testing.assert_array_equal(
        got[0, idx_e[0, 0], idx_c[0, 0]].numpy(), tok[0, 0])
    back = t_moe._combine_gather(got, *ti, e_buf, cap, None)
    np.testing.assert_allclose(
        _np(back), _np(r_moe._combine_gather(want, jnp.asarray(idx_e),
                                             jnp.asarray(idx_c), e_buf, cap,
                                             None)), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("pair", ["dispatch", "combine"])
def test_autograd_pairs_pass_gradcheck(pair):
    idx_e, idx_c, tok, e_buf, cap = _scatter_inputs(np.random.RandomState(36))
    ti = [torch.from_numpy(a).long() for a in (idx_e, idx_c)]
    if pair == "dispatch":
        x = torch.from_numpy(tok).requires_grad_()
        fn = lambda x: t_moe._DispatchScatter.apply(  # noqa: E731
            *ti, x, e_buf, cap)
    else:
        x = torch.from_numpy(np.random.RandomState(37).randn(
            2, e_buf, cap, 3)).requires_grad_()
        fn = lambda x: t_moe._CombineGather.apply(  # noqa: E731
            x, *ti, e_buf, cap)
    assert x.dtype == torch.float64
    assert torch.autograd.gradcheck(fn, (x,))


@pytest.mark.parametrize("pair", ["dispatch", "combine"])
def test_autograd_pairs_backward_matches_the_reference_vjp(pair):
    """Each Function's backward equals ``jax.vjp`` of the reference's
    custom-vjp pair on the same cotangent: the scatter's adjoint is a
    gather, and the gather's a scatter-add (repeated slots summed)."""
    rng = np.random.RandomState(38)
    idx_e, idx_c, tok, e_buf, cap = _scatter_inputs(rng)
    ri = [jnp.asarray(a) for a in (idx_e, idx_c)]
    ti = [torch.from_numpy(a).long() for a in (idx_e, idx_c)]
    if pair == "dispatch":
        x = tok.astype(np.float32)
        g = rng.randn(2, e_buf, cap, 3).astype(np.float32)
        _, vjp = jax.vjp(lambda t: r_moe._dispatch_scatter(
            *ri, t, e_buf, cap, None), jnp.asarray(x))
        xt = torch.from_numpy(x).requires_grad_()
        out = t_moe._dispatch_scatter(*ti, xt, e_buf, cap, None)
    else:
        x = rng.randn(2, e_buf, cap, 3).astype(np.float32)
        g = rng.randn(*tok.shape).astype(np.float32)
        _, vjp = jax.vjp(lambda b: r_moe._combine_gather(
            b, *ri, e_buf, cap, None), jnp.asarray(x))
        xt = torch.from_numpy(x).requires_grad_()
        out = t_moe._combine_gather(xt, *ti, e_buf, cap, None)
    (want,) = vjp(jnp.asarray(g))
    (got,) = torch.autograd.grad(out, xt, torch.from_numpy(g))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)


def test_gradient_reaches_the_experts_through_dispatch_and_combine():
    """The routed MLP is differentiable through both Functions: every
    expert that received a token gets a gradient, as in the reference."""
    rcfg, rparams, tcfg, _ = _pair("granite-moe-1b-a400m")
    rl, tl = _layer(rparams, 0)
    for p in tl.parameters():
        p.requires_grad_()
    x = np.random.RandomState(39).randn(2, 8, rcfg.d_model).astype(np.float32)
    out, aux = t_moe.moe_mlp(tl, torch.from_numpy(x), tcfg, None)
    (out.square().sum() + aux).backward()

    def r_loss(lp):
        o, a = r_moe.moe_mlp(lp, jnp.asarray(x), rcfg, None)
        return jnp.sum(o ** 2) + a

    want = jax.grad(r_loss)(rl)
    for name in ("w_up", "w_gate", "w_down"):
        np.testing.assert_allclose(_np(tl.moe[name].grad),
                                   _np(want["moe"][name]), rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    np.testing.assert_allclose(_np(tl.router.grad), _np(want["router"]),
                               rtol=1e-4, atol=1e-4)

"""The port's encoder-decoder family (whisper-medium) against the
reference's.

Parameters come from ``jax.random.key(0)`` in the reference and are carried
over through ``repro_torch.convert``; tokens and frames come from numpy
seeds.  The reference runs on the CPU as its own tests run it
(``attention_impl`` "pallas" in Pallas interpret mode, or "xla"); the port
runs on CPU tensors, where its ``"cuda"`` attention takes the plain
versions.  Tolerances: 1e-4 for the encoder output, logits and caches of
the f32 smoke config (another order of summation), 2e-3 for teacher-forced
decode against the full decoder, as the reference's
``test_prefill_decode_matches_full_forward``.
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as r_smoke
from repro.models import api as r_api
from repro.models import encdec as r_ed
from repro_torch.configs import get_smoke_config
from repro_torch.convert import config_from_reference, params_from_reference
from repro_torch.models import api as t_api
from repro_torch.models import attention as t_attention
from repro_torch.models import encdec as t_ed

ARCH = "whisper-medium"


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


@functools.lru_cache(maxsize=None)
def _pair(impl="pallas"):
    rcfg = dataclasses.replace(r_smoke(ARCH), attention_impl=impl)
    rparams = r_api.init_params(jax.random.key(0), rcfg)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), rparams)
    tcfg = config_from_reference(rcfg)
    return rcfg, rparams, tcfg, params_from_reference(tree, tcfg, "cpu")


def _batch(cfg, rng, b, s):
    toks = rng.randint(0, cfg.vocab, (b, s)).astype(np.int32)
    frames = rng.randn(b, cfg.enc_frames, cfg.d_model).astype(np.float32)
    return ({"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)},
            {"tokens": torch.from_numpy(toks),
             "frames": torch.from_numpy(frames)})


# -- parameters ---------------------------------------------------------------


def test_params_carry_over_with_counts_and_axes():
    rcfg, rparams, tcfg, tparams = _pair()
    assert t_api.param_count(tparams) == r_api.param_count(rparams)
    np.testing.assert_array_equal(
        _np(tparams.enc_layers[1].attn["wq"]),
        np.asarray(rparams["enc_layers"]["attn"]["wq"][1]))
    np.testing.assert_array_equal(
        _np(tparams.dec_layers[0].cross_attn["wk"]),
        np.asarray(rparams["dec_layers"]["cross_attn"]["wk"][0]))
    np.testing.assert_array_equal(_np(tparams.dec_pos),
                                  np.asarray(rparams["dec_pos"]))
    assert tparams.dec_pos.shape[0] == t_ed.DEC_POSITIONS
    is_leaf = lambda x: isinstance(x, tuple)  # noqa: E731
    assert jax.tree.leaves(t_api.params_logical_axes(tcfg), is_leaf=is_leaf) \
        == jax.tree.leaves(r_api.params_logical_axes(rcfg), is_leaf=is_leaf)
    assert t_api.state_logical_axes(tcfg) == r_api.state_logical_axes(rcfg)
    assert t_ed.MAX_DECODE_LEN_AXIS == r_ed.MAX_DECODE_LEN_AXIS
    own = t_api.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    assert {n: tuple(p.shape) for n, p in own.named_parameters()} == \
        {n: tuple(p.shape) for n, p in tparams.named_parameters()}
    # the cache's leaves, shapes and dtypes are the reference's
    rc = r_api.init_decode_state(rcfg, 3, 20)
    tc = t_api.init_decode_state(tcfg, 3, 20, "cpu")
    assert {k: tuple(v.shape) for k, v in tc.items()} == \
        {k: v.shape for k, v in rc.items()}
    assert tc["pos"].dtype == torch.int32


def test_converting_a_tree_with_the_wrong_depth_raises():
    rcfg, rparams, tcfg, _ = _pair()
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), rparams)
    with pytest.raises(ValueError, match="encoder layers"):
        params_from_reference(tree, tcfg.scaled(n_enc_layers=3), "cpu")


# -- the encoder ---------------------------------------------------------------


def test_sinusoids_are_the_reference_positions():
    """The reference adds these inside ``encode``: its formula, here."""
    f, d = 50, 64
    pos = jnp.arange(f)
    inv = jnp.exp(-jnp.arange(0, d, 2) / d * math.log(10000.0))
    ang = pos[:, None] * inv[None, :]
    want = jnp.concatenate([jnp.sin(ang), jnp.cos(ang)], axis=-1)
    np.testing.assert_allclose(_np(t_ed._sinusoids(f, d, "cpu")),
                               _np(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_encode_matches(impl):
    rcfg, rparams, tcfg, tparams = _pair(impl)
    rb, tb = _batch(rcfg, np.random.RandomState(40), 2, 4)
    want = r_ed.encode(rparams, rb["frames"], rcfg)
    got = t_ed.encode(tparams, tb["frames"], tcfg)
    assert got.shape == (2, tcfg.enc_frames, tcfg.d_model)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)


# -- training and serving passes --------------------------------------------------


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_train_logits_and_loss_match(impl):
    rcfg, rparams, tcfg, tparams = _pair(impl)
    rb, tb = _batch(rcfg, np.random.RandomState(41), 2, 12)
    want = r_ed.decode_train(rparams, rb["tokens"],
                             r_ed.encode(rparams, rb["frames"], rcfg), rcfg)
    got = t_ed.decode_train(tparams, tb["tokens"],
                            t_ed.encode(tparams, tb["frames"], tcfg), tcfg)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)
    via_api, state = t_api.forward(tparams, tb["tokens"], tcfg, mode="train",
                                   frames=tb["frames"])
    assert state is None
    np.testing.assert_allclose(_np(via_api), _np(got), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        float(t_api.train_loss(tparams, tb, tcfg)),
        float(r_api.train_loss(rparams, rb, rcfg)), rtol=1e-5)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_prefill_then_three_decode_steps_match(impl):
    rcfg, rparams, tcfg, tparams = _pair(impl)
    rng = np.random.RandomState(42)
    b, s, max_len = 2, 9, 24
    rb, tb = _batch(rcfg, rng, b, s)
    rstate = r_api.init_decode_state(rcfg, b, max_len)
    tstate = t_api.init_decode_state(tcfg, b, max_len, "cpu")
    rlog, rstate = r_api.prefill(rparams, rb, rcfg, rstate)
    tlog, tstate = t_api.prefill(tparams, tb, tcfg, tstate)
    assert tlog.shape == (b, 1, tcfg.vocab)
    np.testing.assert_allclose(_np(tlog), _np(rlog), rtol=1e-4, atol=1e-4)
    for step in range(3):
        tok = rng.randint(0, rcfg.vocab, (b, 1)).astype(np.int32)
        rlog, rstate = r_api.decode_step(rparams, jnp.asarray(tok), rcfg,
                                         rstate)
        tlog, tstate = t_api.decode_step(tparams, torch.from_numpy(tok),
                                         tcfg, tstate)
        np.testing.assert_allclose(_np(tlog), _np(rlog), rtol=1e-4,
                                   atol=1e-4, err_msg=f"decode step {step}")
    assert sorted(tstate) == sorted(rstate)
    np.testing.assert_array_equal(tstate["pos"].numpy(),
                                  np.asarray(rstate["pos"]))
    for name in ("self_k", "self_v", "cross_k", "cross_v"):
        np.testing.assert_allclose(_np(tstate[name]), _np(rstate[name]),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def test_teacher_forced_decode_matches_full_forward():
    """Decoding the last tokens one at a time against the caches
    reproduces the full decoder's logits, and the API's prefill logits of
    every position end in ``prefill``'s last one."""
    cfg = get_smoke_config(ARCH)
    params = t_api.init_params(torch.Generator().manual_seed(3), cfg, "cpu")
    rng = np.random.RandomState(43)
    toks = torch.from_numpy(rng.randint(0, cfg.vocab, (1, 12))
                            .astype(np.int32))
    frames = torch.from_numpy(rng.randn(1, cfg.enc_frames, cfg.d_model)
                              .astype(np.float32))
    full, _ = t_api.forward(params, toks, cfg, mode="train", frames=frames)
    state = t_api.init_decode_state(cfg, 1, 16, "cpu")
    every, _ = t_api.forward(params, toks, cfg, mode="prefill", frames=frames,
                             state=state)
    np.testing.assert_allclose(_np(every), _np(full), rtol=1e-5, atol=1e-5)
    state = t_api.init_decode_state(cfg, 1, 16, "cpu")
    last, state = t_api.prefill(
        params, {"tokens": toks[:, :9], "frames": frames}, cfg, state)
    np.testing.assert_allclose(_np(last[0, 0]), _np(full[0, 8]), rtol=1e-5,
                               atol=1e-5)
    for i in range(9, 12):
        logits, state = t_api.decode_step(params, toks[:, i:i + 1], cfg,
                                          state)
        np.testing.assert_allclose(_np(logits[0, 0]), _np(full[0, i]),
                                   rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("impl,kernel_calls", [("cuda", 4), ("xla", 0)])
def test_decode_step_takes_the_configured_attention(monkeypatch, impl,
                                                    kernel_calls):
    """A decode step reaches the decode-attention kernel's wrapper twice a
    decoder layer (self- and cross-attention) with ``attention_impl``
    "cuda", and only the plain version otherwise; the reference takes the
    plain version whatever the config says (ROADMAP Queue C).  On CPU
    tensors both give the reference's logits."""
    rcfg, rparams, tcfg, tparams = _pair("xla")
    tcfg = tcfg.scaled(attention_impl=impl)
    calls = []
    wrapper = t_attention.cuda_decode

    def spy(*args, **kw):
        calls.append(kw["kv_len"].tolist())
        return wrapper(*args, **kw)

    monkeypatch.setattr(t_attention, "cuda_decode", spy)
    rng = np.random.RandomState(44)
    rb, tb = _batch(rcfg, rng, 2, 5)
    rstate = r_api.prefill(rparams, rb, rcfg,
                           r_api.init_decode_state(rcfg, 2, 12))[1]
    tstate = t_api.prefill(tparams, tb, tcfg,
                           t_api.init_decode_state(tcfg, 2, 12, "cpu"))[1]
    tok = rng.randint(0, rcfg.vocab, (2, 1)).astype(np.int32)
    want = r_api.decode_step(rparams, jnp.asarray(tok), rcfg, rstate)[0]
    got = t_api.decode_step(tparams, torch.from_numpy(tok), tcfg, tstate)[0]
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)
    assert len(calls) == kernel_calls
    if calls:  # self-attention up to pos + 1, cross over every frame
        assert calls[0] == [6, 6] and calls[1] == [tcfg.enc_frames] * 2

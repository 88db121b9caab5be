"""The port's dense and VLM models against the reference's.

Parameters come from ``jax.random.key(0)`` in the reference and are carried
over through ``repro_torch.convert``; token inputs come from numpy seeds.
The reference runs on the CPU as its own tests run it (``attention_impl``
"pallas" in Pallas interpret mode, or "xla"); the port runs on CPU tensors,
where its ``"cuda"`` attention takes the plain versions.  Tolerances: 1e-4
for logits of the f32 smoke configs (another order of summation), 2e-3 for
teacher-forced decode against the full forward, as the reference's
``test_prefill_decode_matches_full_forward``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as RL
import repro_torch.models.layers as TL
from repro.configs import ARCHS as R_ARCHS
from repro.configs import get_config as r_get_config
from repro.configs import get_smoke_config as r_smoke
from repro.models import api as r_api
from repro.models import kvcache as r_kv
from repro.models import transformer as r_tf
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.convert import config_from_reference, params_from_reference
from repro_torch.models import api as t_api
from repro_torch.models import kvcache as t_kv
from repro_torch.models import transformer as t_tf

DENSE = ["phi3-mini-3.8b", "gemma-2b", "stablelm-3b", "qwen1.5-32b",
         "internvl2-26b"]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


@functools.lru_cache(maxsize=None)
def _pair(arch, impl="pallas"):
    """(reference cfg, its params, port cfg, port params) for a smoke
    config, the port's parameters carried over from the reference's.
    Nothing here writes to them, so each pair is made once."""
    rcfg = dataclasses.replace(r_smoke(arch), attention_impl=impl)
    rparams = r_api.init_params(jax.random.key(0), rcfg)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), rparams)
    tcfg = config_from_reference(rcfg)
    return rcfg, rparams, tcfg, params_from_reference(tree, tcfg, "cpu")


def _batch(cfg, rng, b, s):
    toks = rng.randint(0, cfg.vocab, (b, s)).astype(np.int32)
    r = {"tokens": jnp.asarray(toks)}
    t = {"tokens": torch.from_numpy(toks)}
    if cfg.family == "vlm":
        pe = rng.randn(b, cfg.n_patches, cfg.d_model).astype(np.float32)
        r["patch_embeds"] = jnp.asarray(pe)
        t["patch_embeds"] = torch.from_numpy(pe)
    return r, t


# -- configs ------------------------------------------------------------------


def test_configs_match_the_reference_field_for_field():
    assert ARCHS == R_ARCHS
    for arch in ARCHS:
        for get_r, get_t in ((r_get_config, get_config),
                             (r_smoke, get_smoke_config)):
            r, t = get_r(arch), get_t(arch)
            rf = dataclasses.asdict(r)
            tf = dataclasses.asdict(t)
            assert rf.pop("attention_impl") == "xla"
            assert tf.pop("attention_impl") == "cuda"
            assert rf == tf, arch
            assert config_from_reference(r) == dataclasses.replace(
                t, attention_impl="xla")
    full = get_config("phi3-mini-3.8b")
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.head_dim, full.d_ff, full.vocab, full.dtype) == (
        32, 3072, 32, 32, 96, 8192, 32064, "bfloat16")
    assert full.torch_dtype == torch.bfloat16
    assert get_smoke_config("qwen1.5-32b").kv_quant


def test_config_from_reference_maps_the_kernel_switch():
    r = r_smoke("gemma-2b")
    for rimpl, timpl in (("pallas", "cuda"), ("xla", "xla"),
                         ("naive", "naive")):
        t = config_from_reference(dataclasses.replace(r, attention_impl=rimpl))
        assert t.attention_impl == timpl
    with pytest.raises(ValueError):
        get_smoke_config("gemma-2b").scaled(attention_impl="pallas")


@pytest.mark.parametrize("arch", ARCHS)
def test_parameter_estimates_and_flops_match(arch):
    r, t = r_get_config(arch), get_config(arch)
    assert t_api.active_param_estimate(t) == r_api.active_param_estimate(r)
    for kind in ("train", "prefill", "decode"):
        assert t_api.model_flops_for(t, kind, 4, 128) == \
            r_api.model_flops_for(r, kind, 4, 128)


@pytest.mark.parametrize("arch", ARCHS)
def test_every_family_serves_through_the_api(arch):
    """The reference's ``test_smoke_serve_path`` on the port: every
    architecture's smoke config initialises, prefills (with its patch
    embeddings or encoder frames) and decodes three steps through
    ``models.api``, with finite logits of the right shape."""
    cfg = get_smoke_config(arch)
    params = t_api.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    rng = np.random.RandomState(14)
    b, s = 2, 16
    batch = {"tokens": torch.from_numpy(
        rng.randint(0, cfg.vocab, (b, s)).astype(np.int32))}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(
            rng.randn(b, cfg.enc_frames, cfg.d_model).astype(np.float32))
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.from_numpy(
            rng.randn(b, cfg.n_patches, cfg.d_model).astype(np.float32))
    state = t_api.init_decode_state(cfg, b, 48, "cpu")
    logits, state = t_api.prefill(params, batch, cfg, state)
    for _ in range(4):
        assert logits.shape == (b, 1, cfg.vocab)
        assert bool(torch.isfinite(logits).all()), arch
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        logits, state = t_api.decode_step(params, tok, cfg, state)
    assert np.isfinite(float(t_api.train_loss(params, batch, cfg)))


# -- parameters ---------------------------------------------------------------


@pytest.mark.parametrize("arch", DENSE)
def test_params_carry_over_with_counts_and_axes(arch):
    rcfg, rparams, tcfg, tparams = _pair(arch)
    assert t_api.param_count(tparams) == r_api.param_count(rparams)
    # the carried-over layer i is the reference's stacked slice i
    np.testing.assert_array_equal(
        _np(tparams.layers[1].wq), np.asarray(rparams["layers"]["wq"][1]))
    np.testing.assert_array_equal(
        _np(tparams.layers[0].mlp["w_up"]),
        np.asarray(rparams["layers"]["mlp"]["w_up"][0]))
    assert hasattr(tparams, "lm_head") == (not tcfg.tie_embeddings)
    is_leaf = lambda x: isinstance(x, tuple)  # noqa: E731
    assert jax.tree.leaves(t_api.params_logical_axes(tcfg), is_leaf=is_leaf) \
        == jax.tree.leaves(r_api.params_logical_axes(rcfg), is_leaf=is_leaf)
    assert t_api.state_logical_axes(tcfg) == r_api.state_logical_axes(rcfg)
    # the port's own init gives the reference's shapes and dtypes
    own = t_api.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    assert t_api.param_count(own) == t_api.param_count(tparams)
    assert {n: tuple(p.shape) for n, p in own.named_parameters()} == \
        {n: tuple(p.shape) for n, p in tparams.named_parameters()}


def test_init_params_on_another_device_than_the_generator_raises():
    cfg = get_smoke_config("phi3-mini-3.8b")
    with pytest.raises(ValueError, match="generator"):
        t_api.init_params(torch.Generator(), cfg, "meta")


# -- forward passes -------------------------------------------------------------


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("arch", DENSE)
def test_train_logits_and_loss_match(arch, impl):
    rcfg, rparams, tcfg, tparams = _pair(arch, impl)
    rng = np.random.RandomState(10)
    rb, tb = _batch(rcfg, rng, 2, 12)
    want, _ = r_tf.forward(rparams, rb["tokens"], rcfg, mode="train",
                           extra_embeds=rb.get("patch_embeds"))
    got, _ = t_tf.forward(tparams, tb["tokens"], tcfg, mode="train",
                          extra_embeds=tb.get("patch_embeds"))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        float(t_api.train_loss(tparams, tb, tcfg)),
        float(r_api.train_loss(rparams, rb, rcfg)), rtol=1e-5)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_then_three_decode_steps_match(arch, impl):
    rcfg, rparams, tcfg, tparams = _pair(arch, impl)
    rng = np.random.RandomState(11)
    b, s, max_len = 2, 9, 24
    rb, tb = _batch(rcfg, rng, b, s)
    rstate = r_api.init_decode_state(rcfg, b, max_len)
    tstate = t_api.init_decode_state(tcfg, b, max_len, "cpu")
    rlog, rstate = r_api.prefill(rparams, rb, rcfg, rstate)
    tlog, tstate = t_api.prefill(tparams, tb, tcfg, tstate)
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
    np.testing.assert_array_equal(tstate["pos"].numpy(),
                                  np.asarray(rstate["pos"]))
    for name in r_kv.layer_slice(rstate):
        np.testing.assert_allclose(_np(tstate[name]), _np(rstate[name]),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "gemma-2b"])
def test_teacher_forced_decode_matches_full_forward(arch):
    """The port's own check, as the reference's
    ``test_prefill_decode_matches_full_forward``: decoding the last tokens
    one at a time reproduces the full-context logits."""
    cfg = get_smoke_config(arch)
    params = t_api.init_params(torch.Generator().manual_seed(3), cfg, "cpu")
    rng = np.random.RandomState(12)
    b, s = 1, 12
    toks = torch.from_numpy(rng.randint(0, cfg.vocab, (b, s)).astype(np.int32))
    full, _ = t_tf.forward(params, toks, cfg, mode="train")
    state = t_api.init_decode_state(cfg, b, s + 4, "cpu")
    _, state = t_api.prefill(params, {"tokens": toks[:, :s - 3]}, cfg, state)
    for i in range(s - 3, s):
        logits, state = t_api.decode_step(params, toks[:, i:i + 1], cfg,
                                          state)
        np.testing.assert_allclose(_np(logits[0, 0]), _np(full[0, i]),
                                   rtol=2e-3, atol=2e-3)


def test_int8_cache_stays_close_to_the_full_precision_one():
    """The reference's ``test_int8_kv_cache_close_to_bf16`` on the port."""
    cfg_ref = get_smoke_config("phi3-mini-3.8b")
    cfg = cfg_ref.scaled(kv_quant=True)
    params = t_api.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    toks = torch.from_numpy(
        np.random.RandomState(13).randint(0, cfg.vocab, (1, 16))
        .astype(np.int32))
    st_q = t_api.init_decode_state(cfg, 1, 32, "cpu")
    st_f = t_api.init_decode_state(cfg_ref, 1, 32, "cpu")
    lq, st_q = t_api.prefill(params, {"tokens": toks}, cfg, st_q)
    lf, st_f = t_api.prefill(params, {"tokens": toks}, cfg_ref, st_f)
    tok = lf[:, -1].argmax(-1).to(torch.int32)[:, None]
    lq2, _ = t_api.decode_step(params, tok, cfg, st_q)
    lf2, _ = t_api.decode_step(params, tok, cfg_ref, st_f)
    np.testing.assert_allclose(_np(lq2), _np(lf2), rtol=0.1, atol=0.15)
    assert int(lq2.argmax()) == int(lf2.argmax())


# -- layers ---------------------------------------------------------------------


def test_norms_match():
    rng = np.random.RandomState(20)
    x = rng.randn(3, 5, 16).astype(np.float32)
    scale = (0.1 * rng.randn(16)).astype(np.float32)
    bias = (0.1 * rng.randn(16)).astype(np.float32)
    np.testing.assert_allclose(
        _np(TL.rms_norm(torch.from_numpy(x), torch.from_numpy(scale))),
        _np(RL.rms_norm(jnp.asarray(x), jnp.asarray(scale))),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        _np(TL.layer_norm(torch.from_numpy(x), torch.from_numpy(scale),
                          torch.from_numpy(bias))),
        _np(RL.layer_norm(jnp.asarray(x), jnp.asarray(scale),
                          jnp.asarray(bias))),
        rtol=1e-5, atol=1e-6)
    # zero-initialised RMSNorm scale multiplies by 1 + 0
    for kind in ("rmsnorm", "layernorm"):
        tn = TL.norm_init(16, kind, torch.float32)
        rn = RL.norm_init(16, kind, jnp.float32)
        assert {k: _np(v).tolist() for k, v in tn.items()} == \
            {k: _np(v).tolist() for k, v in rn.items()}
    # computed in f32 and cast back
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert TL.rms_norm(xb, torch.zeros(16)).dtype == torch.bfloat16


def test_rope_rotates_halves_like_the_reference():
    rng = np.random.RandomState(21)
    x = rng.randn(2, 7, 3, 16).astype(np.float32)
    pos = rng.randint(0, 500, (2, 7)).astype(np.int32)
    got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4)
    want = RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(TL.rope_freqs(16, 1e4)),
                               _np(RL.rope_freqs(16, 1e4)), rtol=1e-6)
    # no head axis
    got2 = TL.apply_rope(torch.from_numpy(x[:, :, 0]), torch.from_numpy(pos),
                         1e6)
    want2 = RL.apply_rope(jnp.asarray(x[:, :, 0]), jnp.asarray(pos), 1e6)
    np.testing.assert_allclose(_np(got2), _np(want2), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("activation", ["swiglu", "geglu", "gelu"])
def test_mlps_match(activation):
    rng = np.random.RandomState(22)
    x = rng.randn(2, 5, 16).astype(np.float32)
    names = ["w_up", "w_down"] + (["w_gate"] if activation != "gelu" else [])
    shapes = {"w_up": (16, 24), "w_down": (24, 16), "w_gate": (16, 24)}
    w = {n: (rng.randn(*shapes[n]) / 4).astype(np.float32) for n in names}
    got = TL.mlp_apply({n: torch.from_numpy(a) for n, a in w.items()},
                       torch.from_numpy(x), activation)
    want = RL.mlp_apply({n: jnp.asarray(a) for n, a in w.items()},
                        jnp.asarray(x), activation)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


def test_losses_match():
    rng = np.random.RandomState(23)
    logits = rng.randn(2, 6, 11).astype(np.float32)
    toks = rng.randint(0, 11, (2, 6)).astype(np.int32)
    np.testing.assert_allclose(
        float(TL.causal_lm_loss(torch.from_numpy(logits),
                                torch.from_numpy(toks))),
        float(RL.causal_lm_loss(jnp.asarray(logits), jnp.asarray(toks))),
        rtol=1e-6)
    np.testing.assert_allclose(
        float(TL.softmax_xent(torch.from_numpy(logits),
                              torch.from_numpy(toks), z_loss=1e-2)),
        float(RL.softmax_xent(jnp.asarray(logits), jnp.asarray(toks),
                              z_loss=1e-2)), rtol=1e-6)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_cache_writes_match_per_row_offsets(kv_quant):
    """Rows written at their own offsets (slots diverge), the int8 path's
    per-token scales, and the start clamped near the end of the cache, as
    ``dynamic_update_slice`` clamps it."""
    rcfg = dataclasses.replace(r_smoke("phi3-mini-3.8b"), kv_quant=kv_quant)
    tcfg = config_from_reference(rcfg)
    rng = np.random.RandomState(24)
    b, s, t = 3, 4, 10
    shape = (b, tcfg.n_kv_heads, s, tcfg.head_dim)
    rcache = r_kv.layer_slice(r_kv.init_cache(rcfg, b, t, n_layers=1))
    tcache = t_kv.layer_slice(t_kv.init_cache(tcfg, b, t, n_layers=1,
                                              device="cpu"))
    rl = {k: v[0] for k, v in rcache.items()}
    tl = {k: v[0] for k, v in tcache.items()}
    for pos in ([0, 3, 5], [6, 8, 1]):  # 8 + 4 > 10: clamped to 6
        k = rng.randn(*shape).astype(np.float32)
        v = rng.randn(*shape).astype(np.float32)
        rl = r_kv.update_layer(rcfg, rl, jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(pos, jnp.int32))
        out = t_kv.update_layer(tcfg, tl, torch.from_numpy(k),
                                torch.from_numpy(v),
                                torch.tensor(pos, dtype=torch.int32))
        assert all(out[n] is tl[n] for n in tl)  # written in place
    for name in rl:
        np.testing.assert_allclose(_np(tl[name]), _np(rl[name]), rtol=1e-6,
                                   atol=1e-6, err_msg=name)
    rk, rv = r_kv.read_layer(rcfg, rl)
    tk, tv = t_kv.read_layer(tcfg, tl)
    np.testing.assert_allclose(_np(tk), _np(rk), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_np(tv), _np(rv), rtol=1e-6, atol=1e-6)


def test_quantize_rounds_half_to_even_like_the_reference():
    x = np.array([[0.5, 1.5, 2.5, -0.5, 127.0, -3.5]], np.float32)
    tq, ts = t_kv._quantize(torch.from_numpy(x))
    rq, rs = r_kv._quantize(jnp.asarray(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(rq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(rs), rtol=1e-7)
    st = t_kv.advance({"pos": torch.tensor([1, 2], dtype=torch.int32)}, 3)
    assert st["pos"].tolist() == [4, 5]

"""The port's training path (``optim``, ``train``, ``data``) against the
reference's, on the CPU.

Inputs are made with numpy from seeds; parameters come from
``jax.random.key(0)`` in the reference and are carried over through
``repro_torch.convert`` (the optimizer state too, by
``train_state_from_reference``).  The reference trains as its own tests
train (``attention_impl`` "xla", jitted on the CPU); the port trains
eagerly on CPU tensors with the same ``attention_impl``.  Tolerances: the
schedule and one AdamW update at rtol 1e-6 (float32 arithmetic in another
order); a train step's loss at rtol 1e-5 and gradient norm at rtol 1e-4,
and every new master and moment leaf within 1e-6 + 1e-4 |x| (the
gradients summed in another order); a 10-step loss curve at rtol 1e-3
(that order's differences, carried through ten updates).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro.optim as RO
from repro.configs import ARCHS
from repro.configs import get_smoke_config as r_smoke
from repro.data.pipeline import DataConfig as RDataConfig
from repro.data.pipeline import TokenStream as RTokenStream
from repro.models import api as r_api
from repro.optim.adamw import AdamWState as RAdamWState
from repro.optim.adamw import zero1_axes as r_zero1_axes
from repro.train import train_loop as r_train
from repro_torch import optim as TO
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import config_from_reference, \
    train_state_from_reference
from repro_torch.data import DataConfig, TokenStream, make_batch_specs
from repro_torch.models import api as t_api
from repro_torch.optim.adamw import zero1_axes
from repro_torch.train import train_loop as t_train
from repro_torch.train.train_loop import (
    TrainState,
    init_train_state,
    make_train_step,
    train_state_axes,
)

#: one smoke config of each family
FAMILIES = ["gemma-2b", "internvl2-26b", "granite-moe-1b-a400m", "rwkv6-3b",
            "recurrentgemma-2b", "whisper-medium"]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _xla(arch):
    return dataclasses.replace(get_smoke_config(arch), attention_impl="xla")


# -- schedule -----------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    {},
    {"peak_lr": 1.0, "warmup_steps": 10, "total_steps": 100,
     "min_ratio": 0.1},
    {"peak_lr": 3e-4, "warmup_steps": 50, "total_steps": 1000},
    {"peak_lr": 2e-3, "warmup_steps": 0, "total_steps": 1, "min_ratio": 0.0},
])
def test_schedule_matches_the_reference_at_every_step(kw):
    steps = np.arange(0, 1201)
    want = np.asarray(jax.vmap(lambda s: RO.cosine_with_warmup(s, **kw))(
        jnp.asarray(steps)))
    got_t = TO.cosine_with_warmup(torch.from_numpy(steps), **kw)
    assert got_t.dtype == torch.float32
    np.testing.assert_allclose(got_t.numpy(), want, rtol=1e-6, atol=1e-12)
    got_f = np.array([TO.cosine_with_warmup(int(s), **kw) for s in steps])
    assert isinstance(TO.cosine_with_warmup(3, **kw), float)
    np.testing.assert_allclose(got_f, want, rtol=1e-6, atol=1e-12)


def test_schedule_warmup_and_decay():
    """The reference's ``test_warmup_and_decay`` on the port."""
    kw = {"peak_lr": 1.0, "warmup_steps": 10, "total_steps": 100}
    assert TO.cosine_with_warmup(0, **kw) == 0.0
    assert abs(TO.cosine_with_warmup(10, **kw) - 1.0) < 1e-6
    assert abs(TO.cosine_with_warmup(100, min_ratio=0.1, **kw) - 0.1) < 1e-6


# -- AdamW --------------------------------------------------------------------


def _tree(rng, scale=1.0):
    shapes = {"w": (4, 5), "b": (5,), "sub": {"x": (3,), "y": (2, 3)},
              "stack": [(6,), (2, 2)]}

    def make(s):
        if isinstance(s, dict):
            return {k: make(v) for k, v in s.items()}
        if isinstance(s, list):
            return [make(v) for v in s]
        return (rng.standard_normal(s) * scale).astype(np.float32)
    return make(shapes)


def _to(tree, fn):
    if isinstance(tree, dict):
        return {k: _to(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, fn) for v in tree]
    return fn(tree)


def _flat(tree):
    return jax.tree.leaves(_to(tree, _np))


def _assert_trees(got, want, **tol):
    g, w = _flat(got), _flat(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a, b, **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("history", [False, True])
@pytest.mark.parametrize("clip", [1e9, 1.0])
def test_adamw_update_matches_the_reference(dtype, history, clip):
    """One update on random trees, from a fresh state or one with moments
    at step 7, with the clip inactive or active (gradients of norm > 1)."""
    rng = np.random.default_rng(0)
    params, grads = _tree(rng), _tree(rng, scale=0.5)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    r_params = _to(params, lambda x: jnp.asarray(x, jdt))
    t_params = _to(params, lambda x: torch.from_numpy(x).to(tdt))
    r_grads = _to(grads, lambda x: jnp.asarray(x, jdt))
    t_grads = _to(grads, lambda x: torch.from_numpy(x).to(tdt))
    r_st, t_st = RO.adamw_init(r_params), TO.adamw_init(t_params)
    if history:
        mu, nu = _tree(rng, 0.1), _to(_tree(rng, 0.1), lambda x: x * x)
        r_st = RAdamWState(jnp.asarray(7, jnp.int32), r_st.master,
                           _to(mu, jnp.asarray), _to(nu, jnp.asarray))
        t_st = TO.AdamWState(torch.tensor(7, dtype=torch.int32), t_st.master,
                             _to(mu, torch.from_numpy),
                             _to(nu, torch.from_numpy))
    kw = {"weight_decay": 0.1, "grad_clip": clip}
    r_new, r_st2, r_m = RO.adamw_update(r_grads, r_st, 1e-2,
                                        param_dtype=jdt, **kw)
    before = [x.clone() for x in jax.tree.leaves(
        _to(t_st.master, lambda x: x))]
    t_new, t_st2, t_m = TO.adamw_update(t_grads, t_st, 1e-2,
                                        param_dtype=tdt, **kw)
    # the pure update leaves its argument as it was
    assert all(torch.equal(a, b) for a, b in zip(
        before, jax.tree.leaves(_to(t_st.master, lambda x: x))))
    assert int(t_st2.step) == int(r_st2.step) == (8 if history else 1)
    np.testing.assert_allclose(float(t_m["grad_norm"]),
                               float(r_m["grad_norm"]), rtol=1e-6)
    for got, want in ((t_new, r_new), (t_st2.master, r_st2.master),
                      (t_st2.mu, r_st2.mu), (t_st2.nu, r_st2.nu)):
        _assert_trees(got, want, rtol=1e-6, atol=1e-9)
    assert all(x.dtype == tdt for x in jax.tree.leaves(
        _to(t_new, lambda x: x)))
    assert all(x.dtype == torch.float32 for x in jax.tree.leaves(
        _to(t_st2.master, lambda x: x)))


def test_adamw_in_place_update_equals_the_pure_one():
    """``out=`` (the train step's donation) writes the same numbers into the
    given params and the state's own tensors."""
    rng = np.random.default_rng(1)
    params = _to(_tree(rng), lambda x: torch.from_numpy(x).to(torch.bfloat16))
    grads = _to(_tree(rng, 0.5), torch.from_numpy)
    pure_p, pure_s, _ = TO.adamw_update(grads, TO.adamw_init(params), 3e-3)
    st = TO.adamw_init(params)
    master_buf = st.master["w"]
    out, st2, _ = TO.adamw_update(grads, st, 3e-3, out=params)
    assert out is params and st2 is st and st.master["w"] is master_buf
    for a, b in ((params, pure_p), (st.master, pure_s.master),
                 (st.mu, pure_s.mu), (st.nu, pure_s.nu)):
        assert all(torch.equal(x, y) for x, y in zip(
            jax.tree.leaves(_to(a, lambda x: x)),
            jax.tree.leaves(_to(b, lambda x: x))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_by_chunks_is_bit_equal(dtype, monkeypatch):
    """A leaf updated a chunk at a time (ragged chunks of 7 elements) gives
    the same bits as the leaf at once, pure and in place."""
    import repro_torch.optim.adamw as adamw

    rng = np.random.default_rng(2)
    tdt = getattr(torch, dtype)
    params = _to(_tree(rng), lambda x: torch.from_numpy(x).to(tdt))
    grads = _to(_tree(rng, 0.5), torch.from_numpy)
    want = TO.adamw_update(grads, TO.adamw_init(params), 3e-3,
                           param_dtype=tdt)
    monkeypatch.setattr(adamw, "UPDATE_CHUNK", 7)
    got = TO.adamw_update(grads, TO.adamw_init(params), 3e-3,
                          param_dtype=tdt)
    st = TO.adamw_init(params)
    target = _to(params, lambda x: x.clone())
    TO.adamw_update(grads, st, 3e-3, param_dtype=tdt, out=target)
    for a, b, c in ((got[0], want[0], target), (got[1].master,
                                                  want[1].master, st.master),
                    (got[1].nu, want[1].nu, st.nu)):
        for x, y, z in zip(jax.tree.leaves(_to(a, lambda t: t)),
                           jax.tree.leaves(_to(b, lambda t: t)),
                           jax.tree.leaves(_to(c, lambda t: t))):
            assert torch.equal(x, y) and torch.equal(z, y)


def test_adamw_matches_manual_reference_and_reports_the_norm_before_clip():
    """The reference's ``test_matches_manual_reference`` and
    ``test_grad_clip`` on the port."""
    p = {"w": torch.tensor([[1.0, -2.0], [0.5, 3.0]])}
    g = {"w": torch.tensor([[0.1, -0.2], [0.3, 0.4]])}
    lr, b1, b2, eps, wd = 1e-2, 0.9, 0.95, 1e-8, 0.1
    newp, _, metrics = TO.adamw_update(
        g, TO.adamw_init(p), lr, b1=b1, b2=b2, eps=eps, weight_decay=wd,
        grad_clip=1e9, param_dtype=torch.float32)
    gw, pw = g["w"].numpy(), p["w"].numpy()
    mh, vh = 0.1 * gw / (1 - b1), 0.05 * gw ** 2 / (1 - b2)
    want = pw - lr * (mh / (np.sqrt(vh) + eps) + wd * pw)
    np.testing.assert_allclose(newp["w"].numpy(), want, rtol=1e-6)
    assert float(metrics["grad_norm"]) == float(TO.global_norm(g))
    _, _, m1 = TO.adamw_update({"w": torch.full((4,), 100.0)},
                               TO.adamw_init({"w": torch.ones(4)}), 1e-3,
                               grad_clip=1.0, param_dtype=torch.float32)
    assert float(m1["grad_norm"]) == 200.0


def test_bf16_params_keep_an_f32_master():
    p = {"w": torch.ones(4, dtype=torch.bfloat16)}
    st = TO.adamw_init(p)
    assert st.master["w"].dtype == torch.float32
    newp, st2, _ = TO.adamw_update({"w": torch.full((4,), 1e-3)}, st, 1e-4)
    assert newp["w"].dtype == torch.bfloat16
    assert st2.master["w"].dtype == torch.float32
    # the master keeps what bf16 rounds away
    assert not torch.equal(st2.master["w"], newp["w"].float())
    # f32 params are copied, never aliased
    f = {"w": torch.ones(3)}
    assert TO.adamw_init(f).master["w"].data_ptr() != f["w"].data_ptr()


@pytest.mark.parametrize("arch", ARCHS)
def test_zero1_axes_and_train_state_axes_match_the_reference(arch):
    from repro.configs import get_config as r_config

    rcfg, tcfg = r_config(arch), get_config(arch)
    r_axes = r_api.params_logical_axes(rcfg)
    assert zero1_axes(t_api.params_logical_axes(tcfg)) == r_zero1_axes(r_axes)
    for z in (True, False):
        r, t = r_train.train_state_axes(rcfg, z), train_state_axes(tcfg, z)
        assert t.params == r.params
        for f in ("step", "master", "mu", "nu"):
            assert getattr(t.opt, f) == getattr(r.opt, f), f
    small = {"embed": ("vocab", "d_model"), "norm": ("d_model",),
             "wq": ("d_model", "heads"), "bias": (None,)}
    assert zero1_axes(small) == {"embed": ("vocab", "zero1"),
                                 "norm": ("zero1",),
                                 "wq": ("zero1", "heads"),
                                 "bias": ("zero1",)}


# -- compression --------------------------------------------------------------


def test_int8_roundtrip_matches_the_reference_and_is_bounded():
    x = np.random.RandomState(0).randn(1000) * 3
    rq, rs = RO.compress_int8(jnp.asarray(x, jnp.float32))
    q, s = TO.compress_int8(torch.from_numpy(x.astype(np.float32)))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert float(s) == float(rs)
    back = TO.decompress_int8(q, s)
    np.testing.assert_array_equal(back.numpy(),
                                  np.asarray(RO.decompress_int8(rq, rs)))
    err = np.abs(back.numpy() - x.astype(np.float32))
    assert err.max() <= float(s) * 0.5 + 1e-6
    assert TO.decompress_int8(q, s, torch.bfloat16).dtype == torch.bfloat16


def test_error_feedback_matches_the_reference_over_steps():
    """The reference's ``test_error_feedback_unbiased_over_steps`` on both
    packages: the applied sums agree, and the residual stays bounded."""
    rng = np.random.RandomState(1)
    ef = TO.ErrorFeedback.init({"g": torch.zeros(64)})
    assert ef.residual["g"].dtype == torch.float32
    true_sum = np.zeros(64)
    applied = {"ref": np.zeros(64), "port": np.zeros(64)}
    residual = {"ref": np.zeros(64), "port": np.zeros(64)}
    for _ in range(200):
        g = rng.randn(64)
        true_sum += g
        for side in applied:
            gf = g + residual[side]
            if side == "ref":
                deq = np.asarray(RO.decompress_int8(
                    *RO.compress_int8(jnp.asarray(gf))))
            else:
                deq = TO.decompress_int8(*TO.compress_int8(
                    torch.from_numpy(gf))).numpy()
            applied[side] += deq
            residual[side] = gf - deq
    np.testing.assert_allclose(applied["port"], applied["ref"], rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(applied["port"] + residual["port"], true_sum,
                               rtol=1e-5)
    assert np.abs(residual["port"]).max() < 0.2


# -- data ---------------------------------------------------------------------


@pytest.mark.parametrize("hosts", [1, 2])
def test_batches_equal_the_reference_bit_for_bit(hosts):
    for host in range(hosts):
        kw = dict(vocab=256, seq_len=40, global_batch=6, seed=7,
                  num_hosts=hosts, host_id=host)
        port, ref = TokenStream(DataConfig(**kw)), \
            RTokenStream(RDataConfig(**kw))
        for step in range(5):
            a, b = port.batch_at(step)["tokens"], ref.batch_at(step)["tokens"]
            assert a.dtype == np.int32 and a.shape == (6 // hosts, 40)
            np.testing.assert_array_equal(a, b)


def test_prefetch_thread_yields_the_steps_in_order():
    stream = TokenStream(DataConfig(vocab=64, seq_len=8, global_batch=2),
                         prefetch=2)
    stream.start(first_step=3)
    try:
        it = iter(stream)
        for want in (3, 4, 5):
            step, batch = next(it)
            assert step == want
            np.testing.assert_array_equal(batch["tokens"],
                                          stream.batch_at(want)["tokens"])
    finally:
        stream.stop()
    assert not stream._thread.is_alive()


def test_batch_specs_are_meta_tensors_and_hosts_must_divide_the_batch():
    spec = make_batch_specs(DataConfig(vocab=64, seq_len=8, global_batch=4))
    assert spec["tokens"].device.type == "meta"
    assert spec["tokens"].shape == (4, 8)
    assert spec["tokens"].dtype == torch.int32
    with pytest.raises(ValueError, match="split"):
        DataConfig(vocab=4, seq_len=2, global_batch=3, num_hosts=2).host_batch


# -- the train step against the reference -------------------------------------


def _batches(cfg, rng, b, s):
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    r, t = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    for key, n in (("frames", cfg.enc_frames if cfg.family == "encdec"
                    else 0),
                   ("patch_embeds", cfg.n_patches if cfg.family == "vlm"
                    else 0)):
        if n:
            x = rng.standard_normal((b, n, cfg.d_model)).astype(np.float32)
            r[key], t[key] = jnp.asarray(x), torch.from_numpy(x)
    return r, t


def _with_history(state, rng, step):
    """The reference state with moments from numpy (the first moment of
    scale 1e-3, the second its square plus 1e-8) at ``step``, past the
    schedule's warm-up."""
    hist = lambda a: rng.standard_normal(a.shape).astype(np.float32) * 1e-3
    mu = jax.tree.map(lambda a: jnp.asarray(hist(a)), state.opt.master)
    nu = jax.tree.map(lambda a: jnp.asarray(hist(a) ** 2 + 1e-8),
                      state.opt.master)
    return r_train.TrainState(state.params, RAdamWState(
        jnp.asarray(step, jnp.int32), state.opt.master, mu, nu))


@functools.lru_cache(maxsize=None)
def _reference_state(arch):
    rcfg = r_smoke(arch)
    return rcfg, r_train.init_train_state(jax.random.key(0), rcfg)


def _carried(rstate, tcfg):
    return train_state_from_reference(jax.tree.map(np.asarray, rstate), tcfg,
                                      "cpu")


def _assert_states(got: TrainState, want: TrainState):
    assert int(got.step) == int(want.step)
    for tree in ("master", "mu", "nu"):
        g, w = getattr(got.opt, tree), getattr(want.opt, tree)
        assert list(g) == list(w)
        for name in w:
            np.testing.assert_allclose(_np(g[name]), _np(w[name]),
                                       rtol=1e-4, atol=1e-6,
                                       err_msg=f"{tree}/{name}")


@pytest.mark.parametrize("arch", FAMILIES)
def test_first_step_from_carried_state_matches_the_reference(arch):
    rcfg, rstate = _reference_state(arch)
    rng = np.random.default_rng(3)
    rstate = _with_history(rstate, rng, 60)
    tcfg = config_from_reference(rcfg)
    assert tcfg.attention_impl == "xla"
    tstate = _carried(rstate, tcfg)
    rb, tb = _batches(rcfg, rng, 2, 16)
    r2, rm = r_train.make_train_step(rcfg, donate=False)(rstate, rb)
    t2, tm = make_train_step(tcfg)(tstate, tb)
    np.testing.assert_allclose(float(tm["loss"]), float(rm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(rm["grad_norm"]), rtol=1e-4)
    np.testing.assert_allclose(float(tm["lr"]), float(rm["lr"]), rtol=1e-6)
    _assert_states(t2, _carried(r2, tcfg))


def test_ten_step_loss_curve_matches_the_reference():
    arch = "phi3-mini-3.8b"
    rcfg, rstate = _reference_state(arch)
    tcfg = config_from_reference(rcfg)
    tstate = _carried(rstate, tcfg)
    data = DataConfig(vocab=rcfg.vocab, seq_len=32, global_batch=4, seed=5)
    stream = TokenStream(data)
    constant = lambda step: 1e-3  # noqa: E731 - a rate that moves the loss
    r_fn = r_train.make_train_step(rcfg, lr_schedule=constant, donate=False)
    t_fn = make_train_step(tcfg, lr_schedule=constant)
    r_losses, t_losses = [], []
    for step in range(10):
        toks = stream.batch_at(step)["tokens"]
        rstate, rm = r_fn(rstate, {"tokens": jnp.asarray(toks)})
        tstate, tm = t_fn(tstate, {"tokens": torch.from_numpy(toks)})
        r_losses.append(float(rm["loss"]))
        t_losses.append(float(tm["loss"]))
    np.testing.assert_allclose(t_losses, r_losses, rtol=1e-3)
    assert t_losses[-1] < t_losses[0]


def test_loss_decreases():
    """The reference's ``test_loss_decreases`` on the port."""
    cfg = _xla("phi3-mini-3.8b")
    stream = TokenStream(DataConfig(vocab=cfg.vocab, seq_len=64,
                                    global_batch=8))
    step_fn = make_train_step(cfg)
    state = init_train_state(torch.Generator().manual_seed(0), cfg, "cpu")
    losses = []
    for step in range(30):
        batch = {"tokens": torch.from_numpy(stream.batch_at(step)["tokens"])}
        state, m = step_fn(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.2, losses[::6]
    assert int(state.step) == 30


def test_microbatch_equivalence():
    """The reference's ``test_microbatch_equivalence`` on the port
    (gradient accumulation over 4 microbatches against one batch), from a
    state with moments so that the update moves the params, and with
    ``donate=False`` leaving both given states as they were."""
    cfg = _xla("gemma-2b")
    batch = {"tokens": torch.from_numpy(TokenStream(DataConfig(
        vocab=cfg.vocab, seq_len=32, global_batch=8)).batch_at(0)["tokens"])}
    s1 = init_train_state(torch.Generator().manual_seed(0), cfg, "cpu")
    s1.opt.step.fill_(60)
    for t in list(s1.opt.mu.values()) + list(s1.opt.nu.values()):
        t.fill_(1e-4)
    s4 = init_train_state(torch.Generator().manual_seed(0), cfg, "cpu")
    s4.opt = TO.AdamWState(s1.opt.step.clone(), s4.opt.master,
                           {k: v.clone() for k, v in s1.opt.mu.items()},
                           {k: v.clone() for k, v in s1.opt.nu.items()})
    before = [p.detach().clone() for p in s1.params.parameters()]
    n1, m1 = make_train_step(cfg, microbatches=1, donate=False)(s1, batch)
    n4, m4 = make_train_step(cfg, microbatches=4, donate=False)(s4, batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]),
                               rtol=1e-5)
    moved = 0
    for a, b, c in zip(n1.params.parameters(), n4.params.parameters(),
                       before):
        np.testing.assert_allclose(_np(a), _np(b), rtol=2e-4, atol=2e-5)
        moved += int(not torch.equal(a, c))
    assert moved == len(before)
    assert all(torch.equal(p, c) for p, c in zip(s1.params.parameters(),
                                                 before))
    assert int(s1.step) == 60 and int(n1.step) == 61


def test_donate_updates_the_given_state_in_place():
    cfg = _xla("gemma-2b")
    state = init_train_state(torch.Generator().manual_seed(0), cfg, "cpu")
    embed = state.params.embed
    master = state.opt.master["embed"]
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 8)).astype(np.int32))
    new, _ = make_train_step(cfg, lr_schedule=lambda s: 1e-3)(
        state, {"tokens": toks})
    assert new.params is state.params and new.params.embed is embed
    assert new.opt.master["embed"] is master and int(state.step) == 1
    assert torch.equal(embed.detach(), master)


# -- remat -------------------------------------------------------------------


class _OpCount(TorchDispatchMode):
    """Counts the matrix products that run."""

    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if "mm" in func.__name__:
            self.mm += 1
        return func(*args, **(kwargs or {}))


def _grads(cfg, seed=1):
    params = t_api.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    params.requires_grad_(True)
    rng = np.random.default_rng(seed)
    _, batch = _batches(cfg, rng, 2, 12)
    with _OpCount() as count:
        loss = t_api.train_loss(params, batch, cfg)
        grads = torch.autograd.grad(loss, list(params.parameters()))
    return grads, count.mm


@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_gives_the_same_gradients_bit_for_bit(arch):
    """Remat on against off, by both policies: the same gradients; "nothing"
    runs the layers' matrix products again in the backward pass, "dots"
    saves them and runs none again."""
    base = dataclasses.replace(_xla(arch), remat=False)
    want, products = _grads(base)
    for policy in ("nothing", "dots"):
        got, n = _grads(dataclasses.replace(base, remat=True,
                                            remat_policy=policy))
        assert all(torch.equal(a, b) for a, b in zip(got, want)), policy
        assert (n > products) if policy == "nothing" else (n == products)


def test_remat_is_off_without_autograd():
    """A forward under ``torch.no_grad`` (serving) runs no checkpoint."""
    cfg = dataclasses.replace(_xla("gemma-2b"), remat=True)
    params = t_api.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    toks = torch.zeros((1, 4), dtype=torch.int32)
    with _OpCount() as count:
        t_api.forward(params, toks, cfg)
    with torch.no_grad(), _OpCount() as plain:
        t_api.forward(params, toks, dataclasses.replace(cfg, remat=False))
    assert count.mm == plain.mm


@pytest.mark.parametrize("arch", FAMILIES)
def test_the_gradient_reaches_every_parameter(arch):
    cfg = _xla(arch)
    params = t_api.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    params.requires_grad_(True)
    _, batch = _batches(cfg, np.random.default_rng(2), 2, 12)
    named = dict(params.named_parameters())
    grads = torch.autograd.grad(t_api.train_loss(params, batch, cfg),
                                list(named.values()), allow_unused=True)
    for (name, _), g in zip(named.items(), grads):
        assert g is not None, name
        assert torch.isfinite(g).all() and bool((g != 0).any()), name


# -- what the step refuses ---------------------------------------------------


def test_train_step_refuses_the_forward_only_kernels():
    cfg = get_smoke_config("gemma-2b")
    assert cfg.attention_impl == "cuda"
    with pytest.raises(ValueError, match="forward-only"):
        make_train_step(cfg)
    # a "model" axis of 2 builds a tensor-parallel step for every family;
    # a (4, 1) mesh builds a data-parallel step
    from repro_torch.launch.rules import rules_for

    split = {"data": 2, "model": 2}
    for arch in ("gemma-2b", "granite-moe-1b-a400m", "rwkv6-3b",
                 "recurrentgemma-2b", "whisper-medium"):
        assert make_train_step(_xla(arch), rules=rules_for(_xla(arch), split),
                               mesh=split) is not None
    rwkv = _xla("rwkv6-3b")
    with pytest.raises(ValueError, match="forward-only"):
        make_train_step(dataclasses.replace(rwkv, attention_impl="cuda"),
                        rules=rules_for(rwkv, split), mesh=split)
    mesh = {"data": 4, "model": 1}
    assert make_train_step(_xla("gemma-2b"),
                           rules=rules_for(_xla("gemma-2b"), mesh),
                           mesh=mesh) is not None
    assert t_train.make_train_step(_xla("gemma-2b")) is not None


def test_gradients_are_on_for_training_and_off_for_serving(monkeypatch):
    cfg = _xla("gemma-2b")
    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    state = init_train_state(gen(), cfg, "cpu")
    assert all(p.requires_grad for p in state.params.parameters())
    served = t_api.init_params(gen(), cfg, "cpu")
    assert not any(p.requires_grad for p in served.parameters())
    assert all(torch.equal(a, b) for a, b in zip(
        state.params.parameters(), served.parameters()))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_train_state(gen(), cfg)

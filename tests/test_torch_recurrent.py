"""The recurrent serving paths against the reference: the WKV6 and RG-LRU
scans, and the RWKV-6 and RecurrentGemma models built on them.

Inputs come from numpy seeds and reach both sides as numpy; the reference's
kernels run in Pallas interpret mode, as ``tests/test_kernels.py`` runs
them on the CPU, and the port runs on CPU tensors, where each wrapper takes
its plain version.  Model parameters come from ``jax.random.key(0)`` in the
reference and are carried over through ``repro_torch.convert``.
Tolerances: the reference sweeps' (1e-4; 1e-5 for state chaining) for the
scans, 1e-4 for logits of the f32 smoke configs (another order of
summation), and the reference's 3e-3 for stateful decode against the full
forward.  The CUDA kernels themselves are held against the plain versions
on the GPU by the ``kernels`` phase of ``chip_smoke.py``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels as RK
from repro.configs import get_smoke_config as r_smoke
from repro.models import api as r_api
from repro.models import rglru as r_rglru
from repro.models import rwkv as r_rwkv
from repro_torch.configs import get_smoke_config
from repro_torch.convert import config_from_reference, params_from_reference
from repro_torch.kernels import rg_lru, rg_lru_ref, wkv6, wkv6_ref
from repro_torch.kernels.rg_lru.ref import (
    rg_lru_chunk_carry,
    rg_lru_chunk_local,
    rg_lru_chunked_ref,
    rg_lru_scan,
)
from repro_torch.kernels.rwkv6.ref import (
    wkv6_chunk_carry,
    wkv6_chunk_updates,
    wkv6_chunked_ref,
)
from repro_torch.models import api as t_api
from repro_torch.models import attention as t_attention
from repro_torch.models import rglru as t_rglru
from repro_torch.models import rwkv as t_rwkv
from repro_torch.serve.engine import Request, ServeEngine, _splice_state

ARCHS = ["rwkv6-3b", "recurrentgemma-2b"]
R_MODULE = {"rwkv6-3b": r_rwkv, "recurrentgemma-2b": r_rglru}
T_MODULE = {"rwkv6-3b": t_rwkv, "recurrentgemma-2b": t_rglru}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _normal(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _both(*arrays):
    """The same numpy arrays as jax and as torch arrays."""
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


# -- WKV6 -----------------------------------------------------------------------


def _wkv_inputs(seed, b, h, t, dk, dv):
    """The reference sweep's inputs (tests/test_kernels.py:341-345)."""
    rng = np.random.RandomState(seed)
    return (_normal(rng, b, h, t, dk, scale=0.3),
            _normal(rng, b, h, t, dk, scale=0.3),
            _normal(rng, b, h, t, dv, scale=0.3),
            np.exp(-np.exp(_normal(rng, b, h, t, dk))).astype(np.float32),
            _normal(rng, h, dk, scale=0.3))


@pytest.mark.parametrize("b,h,t,dk,dv,bt", [(2, 2, 64, 16, 16, 16),
                                            (1, 4, 50, 8, 8, 16)])
def test_wkv6_sweep(b, h, t, dk, dv, bt):
    (rr, rt) = _both(*_wkv_inputs(100 + t, b, h, t, dk, dv))
    want, s_want = RK.wkv6(*rr, block_t=bt, return_state=True)
    got, s_got = wkv6(*rt, block_t=bt, return_state=True)
    assert got.shape == (b, h, t, dv) and s_got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(s_got), _np(s_want), rtol=1e-4, atol=1e-4)


def test_wkv6_state_chaining():
    """Processing [0:T] at once == [0:T/2] then [T/2:T] with carried state
    (the reference's ``test_wkv6_state_chaining`` on the port)."""
    _, (r, k, v, w, u) = _both(*_wkv_inputs(101, 1, 2, 32, 8, 8))
    full = wkv6(r, k, v, w, u)
    h1, s1 = wkv6(r[:, :, :16], k[:, :, :16], v[:, :, :16], w[:, :, :16], u,
                  return_state=True)
    h2 = wkv6(r[:, :, 16:], k[:, :, 16:], v[:, :, 16:], w[:, :, 16:], u,
              initial_state=s1)
    np.testing.assert_allclose(_np(torch.cat([h1, h2], dim=2)), _np(full),
                               rtol=1e-5, atol=1e-5)


def test_wkv6_given_state_and_ragged_time():
    """A given s0, and T not a multiple of ``block_t`` (the reference pads
    time with w = 1, k = 0)."""
    b, h, t, dk, dv = 2, 3, 45, 16, 8
    inputs = _wkv_inputs(102, b, h, t, dk, dv)
    s0 = _normal(np.random.RandomState(103), b, h, dk, dv, scale=0.5)
    (rr, rt) = _both(*inputs, s0)
    want, s_want = RK.wkv6(*rr[:5], initial_state=rr[5], block_t=32,
                           return_state=True)
    got, s_got = wkv6(*rt[:5], initial_state=rt[5], block_t=32,
                      return_state=True)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(s_got), _np(s_want), rtol=1e-4, atol=1e-4)
    again = wkv6(*rt[:5], initial_state=rt[5], use_ref=True)
    assert torch.equal(again, wkv6_ref(*rt[:5], rt[5]))


# The chunked scan of the CUDA kernels' route "chunk", written out in plain
# PyTorch (``wkv6_chunked_ref``), against the serial plain version and the
# reference's Pallas kernel (interpret mode) at the reference sweep's 1e-4.


def _exact_decays(w):
    """Decays of exactly 0 (a reset), exactly 1 (no decay) and subnormal
    (about 1e-40) at steps spread over time."""
    w = w.copy()
    w[:, :, ::7] = 0.0
    w[:, :, 3::11] = 1.0
    w[:, :, 5::13] = np.float32(1e-40)
    return w


@pytest.mark.parametrize("chunk_len", [1, 7, 16, 64])
@pytest.mark.parametrize("exact", [False, True])
def test_wkv6_chunked_ref_matches_with_ragged_time_and_a_given_state(
        chunk_len, exact):
    """T = 45, not a multiple of the chunk, from a given s0; with
    ``exact``, decays holding exact 0s, exact 1s and subnormals."""
    b, h, t, dk, dv = 2, 3, 45, 16, 8
    r, k, v, w, u = _wkv_inputs(105, b, h, t, dk, dv)
    if exact:
        w = _exact_decays(w)
        assert (w == 0).any() and (w == 1).any()
        assert ((w > 0) & (w < np.finfo(np.float32).tiny)).any()
    s0 = _normal(np.random.RandomState(106), b, h, dk, dv, scale=0.5)
    (rr, rt) = _both(r, k, v, w, u, s0)
    got, s_got = wkv6_chunked_ref(*rt[:5], rt[5], chunk_len=chunk_len,
                                  return_state=True)
    want, s_want = wkv6_ref(*rt[:5], rt[5], return_state=True)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(s_got), _np(s_want), rtol=1e-4, atol=1e-4)
    ref, s_ref = RK.wkv6(*rr[:5], initial_state=rr[5], block_t=16,
                         return_state=True)
    np.testing.assert_allclose(_np(got), _np(ref), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(s_got), _np(s_ref), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("chunk_len", [4, 16])
def test_wkv6_chunked_ref_state_chaining(chunk_len):
    """[0:T] at once == [0:T/2] then [T/2:T] from the carried state, with
    chunks that straddle neither half's end (T/2 = 20 is no multiple of 16)
    and the reference's own chaining alike."""
    (rr, rt) = _both(*_wkv_inputs(107, 1, 2, 40, 8, 8))
    r, k, v, w, u = rt
    full, s_full = wkv6_chunked_ref(r, k, v, w, u, chunk_len=chunk_len,
                                    return_state=True)
    h1, s1 = wkv6_chunked_ref(r[:, :, :20], k[:, :, :20], v[:, :, :20],
                              w[:, :, :20], u, chunk_len=chunk_len,
                              return_state=True)
    h2, s2 = wkv6_chunked_ref(r[:, :, 20:], k[:, :, 20:], v[:, :, 20:],
                              w[:, :, 20:], u, s1, chunk_len=chunk_len,
                              return_state=True)
    np.testing.assert_allclose(_np(torch.cat([h1, h2], dim=2)), _np(full),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(s2), _np(s_full), rtol=1e-5, atol=1e-5)
    want = RK.wkv6(*rr, block_t=8)
    np.testing.assert_allclose(_np(full), _np(want), rtol=1e-4, atol=1e-4)


def test_wkv6_chunk_passes_carry_a_zero_decay_as_a_reset():
    """A chunk holding an exact 0 decay in every channel has P_c = 0, so
    the state after it is that chunk's own update alone, whatever came
    before: the carry resets as the serial recurrence does."""
    r, k, v, w, u = _wkv_inputs(108, 1, 2, 32, 8, 8)
    w[:, :, 10] = 0.0  # inside the second chunk of 8
    _, (r, k, v, w, u) = _both(r, k, v, w, u)
    ds, decays = wkv6_chunk_updates(k, v, w, 8)
    assert torch.equal(decays[:, :, 1], torch.zeros_like(decays[:, :, 1]))
    assert (decays[:, :, 0] > 0).all()
    s0 = torch.full((1, 2, 8, 8), 3.0)
    starts, _ = wkv6_chunk_carry(ds, decays, s0)
    assert torch.equal(starts[:, :, 0], s0)
    assert torch.equal(starts[:, :, 2], ds[:, :, 1])
    want = wkv6_ref(r[:, :, 16:], k[:, :, 16:], v[:, :, 16:], w[:, :, 16:],
                    u, starts[:, :, 2])
    got = wkv6_chunked_ref(r, k, v, w, u, s0, chunk_len=8)
    np.testing.assert_allclose(_np(got[:, :, 16:]), _np(want), rtol=1e-5,
                               atol=1e-5)


def test_wkv6_ref_rounds_like_the_reference_ref_in_bf16():
    """The plain version rounds as the reference's ``wkv6_ref`` does: the
    outer product and the read in the inputs' type (the CUDA kernel reads
    in f32, as the Pallas kernel; ROADMAP watch-list).  Held to bf16's
    rounding of an output, 2^-8 of the largest."""
    inputs = _wkv_inputs(104, 1, 2, 24, 16, 16)
    bf = [a.astype(jnp.bfloat16) for a in map(jnp.asarray, inputs[:4])]
    want, s_want = RK.wkv6_ref(*bf, jnp.asarray(inputs[4]),
                               return_state=True)
    tb = [torch.from_numpy(a).to(torch.bfloat16) for a in inputs[:4]]
    got, s_got = wkv6_ref(*tb, torch.from_numpy(inputs[4]), return_state=True)
    assert got.dtype == torch.bfloat16 and s_got.dtype == torch.float32
    scale = float(np.abs(_np(want)).max())
    np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                               atol=2.0 ** -8 * scale)
    np.testing.assert_allclose(_np(s_got), _np(s_want), rtol=1e-3, atol=1e-3)


# -- RG-LRU ---------------------------------------------------------------------


def _lru_inputs(seed, b, t, d):
    """The reference sweep's inputs (tests/test_kernels.py:376-378)."""
    rng = np.random.RandomState(seed)
    return (-np.abs(_normal(rng, b, t, d, scale=0.1)), _normal(rng, b, t, d),
            _normal(rng, b, d, scale=0.5))


@pytest.mark.parametrize("b,t,d,bt,bd", [(2, 96, 256, 32, 128),
                                         (1, 64, 64, 16, 64),
                                         (2, 50, 100, 16, 64)])
def test_rg_lru_sweep(b, t, d, bt, bd):
    """Ragged T and D in the last case (the reference pads both)."""
    (rr, rt) = _both(*_lru_inputs(200 + t, b, t, d))
    want, h_want = RK.rg_lru(*rr, block_t=bt, block_d=bd, return_state=True)
    got, h_got = rg_lru(*rt, block_t=bt, block_d=bd, return_state=True)
    assert got.shape == (b, t, d) and h_got.shape == (b, d)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(h_got), _np(h_want), rtol=1e-4, atol=1e-4)


def test_rg_lru_decay_bounds():
    """With log_a = 0 (a=1, beta=0) the state is constant; with very
    negative log_a (a≈0) h_t ≈ gx_t (the reference's
    ``test_rg_lru_decay_bounds`` on the port)."""
    rng = np.random.RandomState(201)
    b, t, d = 1, 16, 32
    gx = torch.from_numpy(_normal(rng, b, t, d))
    h0 = torch.from_numpy(_normal(rng, b, d))
    out = rg_lru_ref(torch.zeros((b, t, d)), gx, h0)
    np.testing.assert_allclose(_np(out), np.broadcast_to(
        _np(h0)[:, None], out.shape), atol=1e-6)
    out2 = rg_lru(torch.full((b, t, d), -50.0), gx, h0)
    np.testing.assert_allclose(_np(out2), _np(gx), atol=1e-5)


def test_rg_lru_final_state_is_f32_like_the_reference_kernel():
    """In bf16, ``rg_lru`` returns the final h in f32, as the reference's
    kernel does; ``rg_lru_ref`` returns it in gx's dtype, as the
    reference's ``rg_lru_ref`` does (ROADMAP watch-list)."""
    la, gx, h0 = _lru_inputs(202, 2, 40, 48)
    rb = [jnp.asarray(a).astype(jnp.bfloat16) for a in (la, gx)]
    tb = [torch.from_numpy(a).to(torch.bfloat16) for a in (la, gx)]
    _, h_kernel = RK.rg_lru(*rb, jnp.asarray(h0), block_t=16,
                            return_state=True)
    _, h_rref = RK.rg_lru_ref(*rb, jnp.asarray(h0), return_state=True)
    out, h_got = rg_lru(*tb, torch.from_numpy(h0), return_state=True)
    out_ref, h_tref = rg_lru_ref(*tb, torch.from_numpy(h0), return_state=True)
    assert h_kernel.dtype == jnp.float32 and h_got.dtype == torch.float32
    assert h_rref.dtype == jnp.bfloat16 and h_tref.dtype == torch.bfloat16
    assert out.dtype == out_ref.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(h_got), _np(h_kernel), rtol=1e-4,
                               atol=1e-4)
    assert torch.equal(h_got.to(torch.bfloat16), h_tref)
    # the outputs in bf16: one rounding of the same f32 values
    np.testing.assert_allclose(_np(out), _np(out_ref), rtol=0, atol=0)


# The chunked scan of the CUDA kernels' route "chunk", written out in plain
# PyTorch (``rg_lru_chunked_ref``), against the serial plain version and the
# reference's Pallas kernel (interpret mode) at the reference sweep's 1e-4.


def _lru_exact_decays(la):
    """log_a of exactly 0 (a = 1, beta = 0: h carried unchanged) and -50
    (a = 2e-22: a chunk's decay product underflows to 0) at steps spread
    over time."""
    la = la.copy()
    la[:, ::9] = 0.0
    la[:, 4::11] = -50.0
    return la


@pytest.mark.parametrize("chunk_len", [1, 7, 64])
@pytest.mark.parametrize("exact", [False, True])
def test_rg_lru_chunked_ref_matches_with_ragged_time_and_a_given_h0(
        chunk_len, exact):
    """T = 150, not a multiple of the chunk, D = 100, from a given h0; with
    ``exact``, log_a holding exact 0s and -50s."""
    la, gx, h0 = _lru_inputs(210, 2, 150, 100)
    if exact:
        la = _lru_exact_decays(la)
        assert (la == 0).any() and (np.exp(la) < 1e-20).any()
    (rr, rt) = _both(la, gx, h0)
    got, h_got = rg_lru_chunked_ref(*rt, chunk_len=chunk_len,
                                    return_state=True)
    want = rg_lru_scan(*rt)
    assert got.dtype == torch.float32 and h_got.shape == (2, 100)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(h_got), _np(want[:, -1]), rtol=1e-4,
                               atol=1e-4)
    ref, h_ref = RK.rg_lru(*rr, block_t=32, block_d=64, return_state=True)
    np.testing.assert_allclose(_np(got), _np(ref), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(h_got), _np(h_ref), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("chunk_len", [4, 16])
def test_rg_lru_chunked_ref_state_chaining(chunk_len):
    """[0:T] at once == [0:T/2] then [T/2:T] from the carried h, with
    chunks that straddle the halves' end (T/2 = 20 is no multiple of 16),
    and the reference alike."""
    la, gx, h0 = _lru_inputs(211, 2, 40, 24)
    (rr, rt) = _both(la, gx, h0)
    la, gx, h0 = rt
    full, h_full = rg_lru_chunked_ref(la, gx, h0, chunk_len=chunk_len,
                                      return_state=True)
    h1, s1 = rg_lru_chunked_ref(la[:, :20], gx[:, :20], h0,
                                chunk_len=chunk_len, return_state=True)
    h2, s2 = rg_lru_chunked_ref(la[:, 20:], gx[:, 20:], s1,
                                chunk_len=chunk_len, return_state=True)
    np.testing.assert_allclose(_np(torch.cat([h1, h2], dim=1)), _np(full),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(s2), _np(h_full), rtol=1e-5, atol=1e-5)
    want = RK.rg_lru(*rr, block_t=8, block_d=128)
    np.testing.assert_allclose(_np(full), _np(want), rtol=1e-4, atol=1e-4)


def test_rg_lru_chunk_passes_carry_an_underflowed_decay_as_a_reset():
    """A chunk whose decays multiply to exactly 0 (log_a = -110 once: a
    underflows to 0 in f32) has A_c = 0, so the h after it is that chunk's
    own scan alone, whatever came before: the carry resets as the serial
    recurrence does."""
    la, gx, _ = _lru_inputs(212, 1, 32, 16)
    la[:, 10] = -110.0  # inside the second chunk of 8
    _, (la, gx) = _both(la, gx)
    hloc, decays = rg_lru_chunk_local(la, gx, 8)
    assert torch.equal(decays[:, 1], torch.zeros_like(decays[:, 1]))
    assert (decays[:, 0] > 0).all()
    h0 = torch.full((1, 16), 3.0)
    starts, _ = rg_lru_chunk_carry(hloc, decays, h0)
    assert torch.equal(starts[:, 0], h0)
    assert torch.equal(starts[:, 2], hloc[:, 1])
    got = rg_lru_chunked_ref(la, gx, h0, chunk_len=8)
    want = rg_lru_scan(la[:, 16:], gx[:, 16:], starts[:, 2])
    np.testing.assert_allclose(_np(got[:, 16:]), _np(want), rtol=1e-5,
                               atol=1e-5)


def test_rg_lru_chunked_ref_rounds_to_gx_dtype_and_keeps_f32_state():
    """In bf16, every h comes back in gx's dtype and the final h in f32, as
    the public ``rg_lru`` returns them; the h before rounding is the f32
    chunked scan's."""
    la, gx, h0 = _lru_inputs(213, 2, 40, 48)
    tb = [torch.from_numpy(a).to(torch.bfloat16) for a in (la, gx)]
    out, h_final = rg_lru_chunked_ref(*tb, torch.from_numpy(h0),
                                      chunk_len=8, return_state=True)
    want, h_want = rg_lru(*tb, torch.from_numpy(h0), return_state=True)
    assert out.dtype == torch.bfloat16 and h_final.dtype == torch.float32
    np.testing.assert_allclose(_np(h_final), _np(h_want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(_np(out), _np(want), rtol=0,
                               atol=2.0 ** -8 * float(np.abs(_np(want)).max()))


# -- models ---------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _pair(arch, impl="pallas", dtype=None):
    """(reference cfg, its params, port cfg, port params) for a smoke
    config, the port's parameters carried over from the reference's.
    Nothing here writes to them, so each pair is made once."""
    rcfg = dataclasses.replace(r_smoke(arch), attention_impl=impl)
    if dtype is not None:
        rcfg = dataclasses.replace(rcfg, dtype=dtype)
    rparams = r_api.init_params(jax.random.key(0), rcfg)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), rparams)
    tcfg = config_from_reference(rcfg)
    return rcfg, rparams, tcfg, params_from_reference(tree, tcfg, "cpu")


def _leaf_dtypes(named) -> dict:
    """{leaf name: sorted dtype names} over (path, array) pairs."""
    out = {}
    for path, x in named:
        name = path.split(".")[-1]
        out.setdefault(name, set()).add(str(x.dtype).replace("torch.", ""))
    return {k: sorted(v) for k, v in out.items()}


def _ref_named(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return [(".".join(str(getattr(p, "key", getattr(p, "idx", p)))
                      for p in path), x) for path, x in flat]


def _tokens(rng, cfg, b, s):
    toks = rng.randint(0, cfg.vocab, (b, s)).astype(np.int32)
    return jnp.asarray(toks), torch.from_numpy(toks)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_carry_over_with_counts_axes_and_dtypes(arch):
    rcfg, rparams, tcfg, tparams = _pair(arch)
    assert t_api.param_count(tparams) == r_api.param_count(rparams)
    is_leaf = lambda x: isinstance(x, tuple)  # noqa: E731
    assert jax.tree.leaves(t_api.params_logical_axes(tcfg), is_leaf=is_leaf) \
        == jax.tree.leaves(r_api.params_logical_axes(rcfg), is_leaf=is_leaf)
    assert jax.tree.leaves(t_api.state_logical_axes(tcfg), is_leaf=is_leaf) \
        == jax.tree.leaves(r_api.state_logical_axes(rcfg), is_leaf=is_leaf)
    # entry i of the port's stack is the reference's stacked slice i
    if arch == "rwkv6-3b":
        got, want = tparams.layers[1].wr, rparams["layers"]["wr"][1]
        tail = None
    else:
        got = tparams.groups[1].rec2.mlp["w_up"]
        want = rparams["groups"]["rec2"]["mlp"]["w_up"][1]
        tail = (tparams.tail[1].gate_a, rparams["tail"][1]["gate_a"])
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    if tail is not None:
        np.testing.assert_array_equal(_np(tail[0]), np.asarray(tail[1]))
    # in a bf16 copy of the config the reference keeps some leaves in f32;
    # carried over and made by the port's own init, they stay f32 too
    rcfg16, rparams16, tcfg16, tparams16 = _pair(arch, dtype="bfloat16")
    want = _leaf_dtypes(_ref_named(rparams16))
    assert _leaf_dtypes(tparams16.named_parameters()) == want
    own = t_api.init_params(torch.Generator().manual_seed(0), tcfg16, "cpu")
    assert _leaf_dtypes(own.named_parameters()) == want
    f32_leaves = {"rwkv6-3b": "bonus", "recurrentgemma-2b": "log_lambda"}
    assert want[f32_leaves[arch]] == ["float32"]
    assert {n: tuple(p.shape) for n, p in own.named_parameters()} == \
        {n: tuple(p.shape) for n, p in tparams16.named_parameters()}
    # the decode state: the same leaves, shapes and dtypes
    rstate = r_api.init_decode_state(rcfg16, 2, 24)
    tstate = t_api.init_decode_state(tcfg16, 2, 24, "cpu")
    assert [(tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for x in jax.tree.leaves(tstate)] == \
        [(tuple(x.shape), str(x.dtype)) for x in jax.tree.leaves(rstate)]


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_logits_and_loss_match(arch, impl):
    rcfg, rparams, tcfg, tparams = _pair(arch, impl)
    rt, tt = _tokens(np.random.RandomState(300), rcfg, 2, 12)
    want, _ = R_MODULE[arch].forward(rparams, rt, rcfg, mode="train")
    got, _ = T_MODULE[arch].forward(tparams, tt, tcfg, mode="train")
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        float(t_api.train_loss(tparams, {"tokens": tt}, tcfg)),
        float(r_api.train_loss(rparams, {"tokens": rt}, rcfg)), rtol=1e-5)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_three_decode_steps_match(arch, impl):
    """Logits and every leaf of the state; the hybrid's prompt (20) is
    longer than its window (16), so its ring buffer wraps."""
    rcfg, rparams, tcfg, tparams = _pair(arch, impl)
    rng = np.random.RandomState(301)
    b, s = 2, 20
    rt, tt = _tokens(rng, rcfg, b, s)
    rstate = r_api.init_decode_state(rcfg, b, s + 4)
    tstate = t_api.init_decode_state(tcfg, b, s + 4, "cpu")
    rlog, rstate = r_api.prefill(rparams, {"tokens": rt}, rcfg, rstate)
    tlog, tstate = t_api.prefill(tparams, {"tokens": tt}, tcfg, tstate)
    np.testing.assert_allclose(_np(tlog), _np(rlog), rtol=1e-4, atol=1e-4)
    for step in range(3):
        rtok, ttok = _tokens(rng, rcfg, b, 1)
        rlog, rstate = r_api.decode_step(rparams, rtok, rcfg, rstate)
        tlog, tstate = t_api.decode_step(tparams, ttok, tcfg, tstate)
        assert tlog.shape == (b, 1, tcfg.vocab)
        np.testing.assert_allclose(_np(tlog), _np(rlog), rtol=1e-4,
                                   atol=1e-4, err_msg=f"decode step {step}")
    r_leaves = jax.tree_util.tree_flatten_with_path(rstate)[0]
    t_leaves = jax.tree.leaves(tstate)
    assert len(t_leaves) == len(r_leaves)
    for (path, want), got in zip(r_leaves, t_leaves):
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("arch", ARCHS)
def test_stateful_decode_matches_full_forward(arch):
    """The port's own check, as the reference's
    ``test_stateful_decode_matches_full_forward``: decoding the last tokens
    one at a time reproduces the full-context logits; the hybrid's 24
    tokens run past its window of 16."""
    cfg = get_smoke_config(arch)
    params = t_api.init_params(torch.Generator().manual_seed(3), cfg, "cpu")
    s = 12 if arch == "rwkv6-3b" else 24
    _, toks = _tokens(np.random.RandomState(302), cfg, 1, s)
    full, _ = T_MODULE[arch].forward(params, toks, cfg, mode="train")
    state = t_api.init_decode_state(cfg, 1, s + 4, "cpu")
    _, state = t_api.prefill(params, {"tokens": toks[:, :s - 3]}, cfg, state)
    for i in range(s - 3, s):
        logits, state = t_api.decode_step(params, toks[:, i:i + 1], cfg,
                                          state)
        np.testing.assert_allclose(_np(logits[0, 0]), _np(full[0, i]),
                                   rtol=3e-3, atol=3e-3)


def test_hybrid_smoke_has_groups_and_a_tail():
    """The smoke config exercises both parts of the hybrid's layout, and
    three layers are the fewest that hold an attention block."""
    cfg = get_smoke_config("recurrentgemma-2b")
    assert t_rglru.n_groups(cfg) == r_rglru.n_groups(r_smoke(
        "recurrentgemma-2b")) == (2, 2)
    assert t_rglru.n_groups(cfg.scaled(n_layers=2)) == (0, 2)
    assert t_rglru.n_groups(cfg.scaled(n_layers=3)) == (1, 0)


def test_decode_state_is_returned_new_and_the_ring_written_in_place():
    """A decode step leaves the recurrent state it was given as it was
    (so two passes can start from one state) and writes the new token's
    k, v and position into the ring buffer's slot ``pos % window``."""
    cfg = get_smoke_config("recurrentgemma-2b")
    params = t_api.init_params(torch.Generator().manual_seed(4), cfg, "cpu")
    _, toks = _tokens(np.random.RandomState(303), cfg, 2, 18)
    state = t_api.init_decode_state(cfg, 2, 32, "cpu")
    _, state = t_api.prefill(params, {"tokens": toks}, cfg, state)
    h_before = state["rec1"]["h"].clone()
    ring = state["attn_k"]
    _, new = t_api.decode_step(params, toks[:, :1], cfg, state)
    assert torch.equal(state["rec1"]["h"], h_before)
    assert new["attn_k"] is ring
    assert new["slot_pos"][:, :, 18 % 16].tolist() == [[18, 18], [18, 18]]
    assert new["pos"].tolist() == [19, 19]


def _kernel_calls(monkeypatch) -> list:
    """The kv_len of every call of the decode-attention wrapper that the
    models' ``attention_impl="cuda"`` path makes (on CPU tensors it takes
    the plain version)."""
    calls, wrapped = [], t_attention.cuda_decode

    def spy(q, k, v, *, kv_len, **kw):
        calls.append(kv_len.clone())
        return wrapped(q, k, v, kv_len=kv_len, **kw)

    monkeypatch.setattr(t_attention, "cuda_decode", spy)
    return calls


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_hybrid_decode_past_the_wrap_matches_the_reference(impl,
                                                           monkeypatch):
    """A prompt of 10 tokens, then 24 decode steps, past the window of 16
    at the 7th step and again at the 23rd: the port's logits at every step
    and its state at the end within the reference's 1e-4 (the reference's
    decode is eager einsum over the ring either way).  With "cuda" (the
    reference's "pallas") the port's ring-buffer attention is the
    decode-attention wrapper on the cache as it lies, one call an attention
    block a step with kv_len = min(pos + 1, window); with "xla", eager."""
    rcfg, rparams, tcfg, tparams = _pair("recurrentgemma-2b", impl)
    calls = _kernel_calls(monkeypatch)
    rng = np.random.RandomState(304)
    b, s, steps = 2, 10, 24
    rt, tt = _tokens(rng, rcfg, b, s)
    rstate = r_api.init_decode_state(rcfg, b, s + steps)
    tstate = t_api.init_decode_state(tcfg, b, s + steps, "cpu")
    rlog, rstate = r_api.prefill(rparams, {"tokens": rt}, rcfg, rstate)
    tlog, tstate = t_api.prefill(tparams, {"tokens": tt}, tcfg, tstate)
    np.testing.assert_allclose(_np(tlog), _np(rlog), rtol=1e-4, atol=1e-4)
    for step in range(steps):
        rtok, ttok = _tokens(rng, rcfg, b, 1)
        rlog, rstate = r_api.decode_step(rparams, rtok, rcfg, rstate)
        tlog, tstate = t_api.decode_step(tparams, ttok, tcfg, tstate)
        np.testing.assert_allclose(_np(tlog), _np(rlog), rtol=1e-4,
                                   atol=1e-4, err_msg=f"decode step {step}")
    for name in ("attn_k", "attn_v", "slot_pos", "pos"):
        np.testing.assert_allclose(_np(tstate[name]), _np(rstate[name]),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    groups = t_rglru.n_groups(tcfg)[0]
    if impl == "xla":
        assert calls == []
        return
    win = tcfg.window
    assert len(calls) == groups * steps
    for step in range(steps):
        want = [min(s + step + 1, win)] * b
        for call in calls[step * groups:(step + 1) * groups]:
            assert call.dtype == torch.int32 and call.tolist() == want


def _assert_ring_prefix(state: dict, window: int) -> None:
    """In every attention block and row, the slots holding a position the
    row has seen (0 <= slot_pos < pos) are exactly the first
    min(pos, window)."""
    slot_pos, pos = state["slot_pos"], state["pos"]
    for g in range(slot_pos.shape[0]):
        for r, n in enumerate(pos.tolist()):
            seen = (slot_pos[g, r] >= 0) & (slot_pos[g, r] < n)
            assert seen.tolist() == [i < min(n, window)
                                     for i in range(window)], (g, r, n)


def test_ring_buffer_valid_slots_are_a_prefix(monkeypatch):
    """The claim the kernel path rests on: the ring fills its slots in
    order and a slot's cache comes whole from its own prefill, so after a
    prefill and after every decode step the valid slots are a prefix, and
    each decode-attention call's kv_len is its length.  Rows prefilled
    alone (5 and 20 tokens, the second past the window) and spliced in as
    the engine does, and an empty row, through 24 steps past the wrap."""
    cfg = get_smoke_config("recurrentgemma-2b")
    win = cfg.window
    params = t_api.init_params(torch.Generator().manual_seed(5), cfg, "cpu")
    calls = _kernel_calls(monkeypatch)
    _, toks = _tokens(np.random.RandomState(305), cfg, 1, 20)
    state = t_api.init_decode_state(cfg, 3, 64, "cpu")
    for slot, n in ((0, 5), (2, 20)):  # slot 1 stays empty
        one = t_api.init_decode_state(cfg, 1, 64, "cpu")
        _, one = t_api.prefill(params, {"tokens": toks[:, :n]}, cfg, one)
        _assert_ring_prefix(one, win)
        state = _splice_state(state, one, slot)
    _assert_ring_prefix(state, win)
    assert state["pos"].tolist() == [5, 0, 20]
    for step in range(24):
        before = state["pos"].clone()
        tok = toks[:, step % 20].repeat(3)[:, None]
        _, state = t_api.decode_step(params, tok, cfg, state)
        _assert_ring_prefix(state, win)
        want = torch.clamp(before + 1, max=win).tolist()
        assert [c.tolist() for c in calls] == [want] * len(calls)
        calls.clear()


def test_ring_buffer_prefix_holds_through_engine_refills(monkeypatch):
    """The same claim through ``ServeEngine``: two slots, four requests, so
    that finished slots are refilled by a splice mid-run; rows run past
    the window (prompt 20; 5 + 14 and 3 + 20 tokens)."""
    cfg = get_smoke_config("recurrentgemma-2b")
    win = cfg.window
    params = t_api.init_params(torch.Generator().manual_seed(6), cfg, "cpu")
    calls = _kernel_calls(monkeypatch)
    engine = ServeEngine(params, cfg, slots=2, max_len=64, seed=0,
                         device="cpu")
    rng = np.random.RandomState(306)
    for rid, (plen, new) in enumerate(((5, 14), (20, 4), (3, 20), (12, 6))):
        engine.submit(Request(
            rid=rid, prompt=rng.randint(0, cfg.vocab, plen).astype(np.int32),
            max_new_tokens=new))
    refills, held = 0, [False, False]
    for _ in range(100):
        occupied = list(engine.slot_req)
        engine._fill_slots()
        for s, (was, now) in enumerate(zip(occupied, engine.slot_req)):
            refills += held[s] and was is None and now is not None
            held[s] = held[s] or now is not None
        _assert_ring_prefix(engine.state, win)
        if all(r is None for r in engine.slot_req):
            break
        before = engine.state["pos"].clone()
        engine._decode_once()
        _assert_ring_prefix(engine.state, win)
        want = torch.clamp(before + 1, max=win).tolist()
        assert [c.tolist() for c in calls] == [want] * len(calls)
        calls.clear()
    assert len(engine.completed) == 4 and refills == 2
    assert all(r.status == "ok" for r in engine.completed)


#: per dtype: the shallow and the full depth, the most the reference's two
#: WKV paths may part at the shallow one, and by how much more they must
#: part at the full one
AMPLIFIED = {"float32": ((2, 32), 1e-4, 50.0),
             "bfloat16": ((1, 4), 3e-2, 2.5)}


@pytest.mark.parametrize("dtype", list(AMPLIFIED))
def test_rwkv_amplifies_rounding_through_depth(dtype):
    """With random weights RWKV-6 amplifies rounding through depth in the
    reference itself.  rwkv6-3b's heads of 64 at d_model 512 (its d_ff
    ratio, a 4096-token vocabulary), 64 tokens: the reference's two WKV
    paths (the Pallas kernel in interpret mode and ``wkv6_ref``), which
    differ only in where they round, agree at a shallow depth and part by
    many times as much at a deeper one: in f32 from 2 layers to rwkv6-3b's
    32, in bf16 already from 1 layer to 4.  The port's plain path on the
    same weights stays within the shallow limit there and within ten times
    the reference's own gap at the deeper depth.  This is why the GPU check
    holds each WKV6 call of rwkv6-3b at full depth, and its logits at cut
    depths (``chip_smoke.py``'s F32_LAYERS and RWKV_LOGIT_LAYERS), not its
    full-depth bf16 logits."""
    (shallow, deep), agree, grow = AMPLIFIED[dtype]
    gaps = {}
    for n_layers in (shallow, deep):
        rcfg = dataclasses.replace(
            r_smoke("rwkv6-3b"), n_layers=n_layers, d_model=512, d_ff=1792,
            vocab=4096, wkv_head_dim=64, attention_impl="xla", dtype=dtype)
        rparams = r_api.init_params(jax.random.key(0), rcfg)
        rt, tt = _tokens(np.random.RandomState(304), rcfg, 1, 64)
        got = {}
        for impl in ("pallas", "xla"):
            c = dataclasses.replace(rcfg, attention_impl=impl)
            got[impl] = np.asarray(jax.jit(
                lambda p, t, c=c: r_rwkv.forward(p, t, c, mode="train")[0])(
                    rparams, rt).astype(jnp.float32), np.float64)
        tcfg = config_from_reference(rcfg)
        tparams = params_from_reference(
            jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)),
                         rparams), tcfg, "cpu")
        with torch.no_grad():
            got["port"] = t_rwkv.forward(
                tparams, tt, tcfg.scaled(attention_impl="naive"),
                mode="train")[0].double().numpy()
        scale = np.abs(got["xla"]).max()
        gaps[n_layers] = {
            "reference": np.abs(got["pallas"] - got["xla"]).max() / scale,
            "port": max(np.abs(got["port"] - got[i]).max() / scale
                        for i in ("pallas", "xla"))}
    assert gaps[shallow]["reference"] < agree, gaps
    assert gaps[shallow]["port"] < agree, gaps
    assert gaps[deep]["reference"] > grow * gaps[shallow]["reference"], gaps
    assert gaps[deep]["port"] < 10 * gaps[deep]["reference"], gaps

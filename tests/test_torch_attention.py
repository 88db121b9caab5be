"""The port's attention kernels' public functions and attention module
against the reference's.

The reference's ops run as its own tests run them on a CPU (Pallas
interpret mode); the port runs on CPU tensors, where ``flash_attention``
and ``decode_attention`` take their plain versions.  Inputs come from numpy
seeds.  Tolerances are those of ``tests/test_kernels.py`` for the same
function: f32 2e-4 (another order of summation), bf16 3e-2 (8 bits of
mantissa), lse 1e-4.  The CUDA kernels themselves are held against the
plain versions on the GPU by the ``kernels`` and ``serve`` phases of
``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels as RK
import repro.models.attention as RA
import repro_torch.kernels as TK
import repro_torch.models.attention as TA
from repro.models import transformer as r_tf
from repro_torch.models import transformer as t_tf


def _f32(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _qkv(rng, b, hq, hkv, s, t, d):
    return (_f32(rng, b, hq, s, d, scale=0.5), _f32(rng, b, hkv, t, d, scale=0.5),
            _f32(rng, b, hkv, t, d, scale=0.5))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# -- flash attention -------------------------------------------------------------


@pytest.mark.parametrize("b,hq,hkv,s,d,window", [
    (2, 4, 4, 128, 64, None),   # MHA
    (1, 8, 2, 256, 64, None),   # GQA
    (1, 4, 1, 128, 32, None),   # MQA
    (1, 4, 1, 128, 32, 64),     # sliding window
    (2, 4, 2, 100, 32, None),   # unaligned seq
])
def test_flash_attention_sweep(b, hq, hkv, s, d, window):
    rng = np.random.RandomState(100 + s + d)
    q, k, v = _qkv(rng, b, hq, hkv, s, s, d)
    want = RK.flash_attention(*_j(q, k, v), causal=True, window=window,
                              block_q=64, block_k=64)
    got = TK.flash_attention(*_t(q, k, v), causal=True, window=window,
                             block_q=64, block_k=64)
    assert got.shape == (b, hq, s, d) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-4, atol=2e-4)


def test_flash_attention_bf16():
    rng = np.random.RandomState(101)
    q, k, v = _qkv(rng, 1, 4, 4, 128, 128, 64)
    want = RK.flash_attention(*[x.astype(jnp.bfloat16) for x in _j(q, k, v)],
                              block_q=64, block_k=64)
    got = TK.flash_attention(*[x.to(torch.bfloat16) for x in _t(q, k, v)],
                             block_q=64, block_k=64)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("s,t,q_offset,window", [
    (40, 100, 60, None),   # queries at the end of a longer, ragged cache
    (17, 300, 283, 50),    # T a multiple of no block, with a window
    (1, 77, 76, None),     # one query row
])
def test_flash_attention_q_offset_with_s_below_t(s, t, q_offset, window):
    rng = np.random.RandomState(102 + t)
    q, k, v = _qkv(rng, 1, 4, 2, s, t, 32)
    want = RK.flash_attention(*_j(q, k, v), causal=True, window=window,
                              q_offset=q_offset, block_q=64, block_k=64)
    got = TK.flash_attention(*_t(q, k, v), causal=True, window=window,
                             q_offset=q_offset)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-4, atol=2e-4)


def test_flash_attention_non_causal_ragged_t_is_masked():
    """The reference's wrapper refuses a non-causal ragged T; the port masks
    it, and agrees with the reference's oracle."""
    rng = np.random.RandomState(103)
    q, k, v = _qkv(rng, 1, 4, 2, 30, 100, 32)
    with pytest.raises(NotImplementedError):
        RK.flash_attention(*_j(q, k, v), causal=False, block_q=64,
                           block_k=64)
    want = RK.attention_ref(*_j(q, k, v), causal=False)
    got = TK.flash_attention(*_t(q, k, v), causal=False)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-4, atol=2e-4)


def test_xla_attention_masks_the_padded_keys_of_a_non_causal_ragged_t():
    """``xla_flash_attention`` pads T to whole blocks with zero keys.  The
    reference masks them only through the causal or window mask, so its
    non-causal result counts them in the softmax and parts from its own
    ``attention_ref``; the port masks keys past T whatever ``causal`` says,
    and its three paths agree with ``attention_ref`` (ROADMAP Queue C)."""
    rng = np.random.RandomState(105)
    q, k, v = _qkv(rng, 1, 4, 2, 30, 100, 32)
    want = RK.attention_ref(*_j(q, k, v), causal=False)
    diluted = RA.xla_flash_attention(*_j(q, k, v), causal=False, block_k=64)
    assert np.abs(_np(diluted) - _np(want)).max() > 1e-2
    got = {
        "xla": TA.xla_flash_attention(*_t(q, k, v), causal=False, block_k=64),
        "naive": TA.multihead_attention(*_t(q, k, v), impl="naive",
                                        causal=False),
        "cuda": TA.multihead_attention(*_t(q, k, v), impl="cuda",
                                       causal=False),
    }
    for impl, out in got.items():
        np.testing.assert_allclose(_np(out), _np(want), rtol=2e-4, atol=2e-4,
                                   err_msg=impl)
    # a causal ragged T was already right, and stays so
    np.testing.assert_allclose(
        _np(TA.xla_flash_attention(*_t(q, k, v), causal=True, q_offset=70,
                                   block_k=64)),
        _np(RA.xla_flash_attention(*_j(q, k, v), causal=True, q_offset=70,
                                   block_k=64)), rtol=2e-4, atol=2e-4)


def test_flash_attention_use_ref_and_scale():
    rng = np.random.RandomState(104)
    q, k, v = _t(*_qkv(rng, 1, 2, 2, 16, 16, 16))
    assert torch.equal(TK.flash_attention(q, k, v, use_ref=True),
                       TK.attention_ref(q, k, v))
    want = RK.attention_ref(*_j(*[x.numpy() for x in (q, k, v)]), scale=0.3)
    np.testing.assert_allclose(_np(TK.flash_attention(q, k, v, scale=0.3)),
                               _np(want), rtol=2e-4, atol=2e-4)


# -- decode attention --------------------------------------------------------------


@pytest.mark.parametrize("b,hq,hkv,t,d", [(2, 8, 2, 512, 64),
                                          (1, 4, 4, 300, 32),
                                          (2, 4, 1, 256, 64)])
def test_decode_attention_sweep(b, hq, hkv, t, d):
    rng = np.random.RandomState(110 + t)
    q = _f32(rng, b, hq, d, scale=0.5)
    k = _f32(rng, b, hkv, t, d, scale=0.5)
    v = _f32(rng, b, hkv, t, d, scale=0.5)
    kv_len = rng.randint(t // 2, t, b).astype(np.int32)
    want, lse_r = RK.decode_attention(*_j(q, k, v), kv_len=jnp.asarray(kv_len),
                                      block_k=128, with_lse=True)
    got, lse = TK.decode_attention(*_t(q, k, v), kv_len=torch.from_numpy(kv_len),
                                   block_k=128, with_lse=True)
    assert got.shape == (b, hq, d) and lse.shape == (b, hq)
    assert lse.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(_np(lse), _np(lse_r), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kv_len", [None, 1, 137, "vector"])
def test_decode_attention_kv_len_forms(kv_len):
    """``kv_len`` as None (the whole cache), a scalar (1: one key) or (B,)."""
    rng = np.random.RandomState(111)
    q = _f32(rng, 3, 4, 32, scale=0.5)
    k = _f32(rng, 3, 2, 300, 32, scale=0.5)
    v = _f32(rng, 3, 2, 300, 32, scale=0.5)
    if kv_len == "vector":
        r_len = jnp.asarray([1, 150, 300], jnp.int32)
        t_len = torch.tensor([1, 150, 300], dtype=torch.int32)
    else:
        r_len = t_len = kv_len
    want, lse_r = RK.decode_attention(*_j(q, k, v), kv_len=r_len,
                                      with_lse=True)
    got, lse = TK.decode_attention(*_t(q, k, v), kv_len=t_len, with_lse=True)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(_np(lse), _np(lse_r), rtol=1e-4, atol=1e-4)
    out_only = TK.decode_attention(*_t(q, k, v), kv_len=t_len)
    assert torch.equal(out_only, got)


def test_decode_attention_bf16():
    rng = np.random.RandomState(112)
    q = _f32(rng, 2, 8, 64, scale=0.5)
    k = _f32(rng, 2, 1, 256, 64, scale=0.5)
    v = _f32(rng, 2, 1, 256, 64, scale=0.5)
    kv_len = np.array([100, 256], np.int32)
    want = RK.decode_attention(*[x.astype(jnp.bfloat16) for x in _j(q, k, v)],
                               kv_len=jnp.asarray(kv_len), block_k=128)
    got = TK.decode_attention(*[x.to(torch.bfloat16) for x in _t(q, k, v)],
                              kv_len=torch.from_numpy(kv_len))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), rtol=3e-2, atol=3e-2)


def test_decode_lse_partial_combine():
    """Flash-decode: two half-cache partials combined by their LSE equal
    attention over the whole cache (the property split-T rests on)."""
    rng = np.random.RandomState(113)
    b, h, t, d = 1, 4, 256, 32
    q, k, v = _t(_f32(rng, b, h, d, scale=0.5), _f32(rng, b, h, t, d, scale=0.5),
                 _f32(rng, b, h, t, d, scale=0.5))
    full = TK.decode_attention_ref(q, k, v)
    o1, l1 = TK.decode_attention(q, k[:, :, :128], v[:, :, :128],
                                 with_lse=True)
    o2, l2 = TK.decode_attention(q, k[:, :, 128:], v[:, :, 128:],
                                 with_lse=True)
    m = torch.maximum(l1, l2)
    w1, w2 = torch.exp(l1 - m)[..., None], torch.exp(l2 - m)[..., None]
    combined = (o1 * w1 + o2 * w2) / (w1 + w2)
    np.testing.assert_allclose(_np(combined), _np(full), rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(TK.decode_attention(q, k, v, use_ref=True), full)


@pytest.mark.parametrize("batch,kv_heads,t,plan", [
    (8, 32, 2184, (9, 4)),   # phi3-mini's decode: 256 blocks unsplit
    (8, 1, 2184, (35, 1)),   # gemma-2b's MQA: 8 blocks, a tile a split
    (64, 64, 2184, (1, 35)),  # enough blocks: no split
    (1, 1, 10, (1, 1)),       # one tile
])
def test_decode_split_plan_aims_at_sixteen_blocks_an_sm(monkeypatch, batch,
                                                        kv_heads, t, plan):
    """The decode kernel's split of the cache, in whole 64-key tiles, for an
    H100's 132 SMs (pure host arithmetic: no card needed)."""
    from repro_torch.kernels.decode_attention import kernel as dk
    monkeypatch.setattr(dk, "sm_count", lambda index: 132)
    splits, per_split = dk.split_plan(batch, kv_heads, t,
                                      torch.device("cuda", 0))
    assert (splits, per_split) == plan
    assert (splits - 1) * per_split < -(-t // dk.TILE) <= splits * per_split


@pytest.mark.parametrize("batch,kv_heads,t,plan", [
    (8, 32, 2184, (5, 7)),    # phi3-mini's decode: 256 blocks, 7 tiles a split
    (8, 1, 2184, (18, 2)),    # gemma-2b's MQA: 2 tiles a split
    (8, 1, 2048, (16, 2)),    # recurrentgemma-2b's ring: 2 tiles, not 1
    (64, 64, 2184, (5, 7)),   # enough blocks, still at most 7 tiles a split
    (8, 32, 300, (2, 3)),     # a short cache: 2 splits for 2 blocks an SM
    (1, 1, 10, (1, 1)),       # one tile
])
def test_decode_split_plan_of_the_tensor_core_route(monkeypatch, batch,
                                                    kv_heads, t, plan):
    """Route "mma" keeps two or three tiles in flight a block: it aims at 2
    blocks an SM with 2 to 7 tiles a split (the counts measured best on an
    H100, ``tools/decode_splits.py``; pure host arithmetic here)."""
    from repro_torch.kernels.decode_attention import kernel as dk
    monkeypatch.setattr(dk, "sm_count", lambda index: 132)
    splits, per_split = dk.split_plan(batch, kv_heads, t,
                                      torch.device("cuda", 0), "mma")
    assert (splits, per_split) == plan
    tiles = -(-t // dk.TILE)
    assert (splits - 1) * per_split < tiles <= splits * per_split
    assert per_split <= 7 and (per_split >= 2 or tiles < 2)


@pytest.mark.parametrize("batch,kv_heads,t,plan", [
    (8, 40, 2184, (5, 7)),    # qwen1.5-32b's decode on its int8 cache
    (8, 40, 546, (2, 5)),     # a rank's run of it split by sequence
    (8, 1, 2184, (18, 2)),    # one kv head: 2 tiles a split, not 1
    (64, 64, 2184, (5, 7)),   # enough blocks, still at most 8 tiles a split
    (1, 1, 10, (1, 1)),       # one tile
])
def test_decode_split_plan_of_the_int8_cuda_core_route(monkeypatch, batch,
                                                       kv_heads, t, plan):
    """Route "gemv" of the int8 cache aims at ``BLOCKS_PER_SM["gemv"]``
    blocks an SM within ``GEMV_TILES_PER_SPLIT`` tiles a split, and no split
    of a full-length row is empty (pure host arithmetic, an H100's 132
    SMs)."""
    from repro_torch.kernels.decode_attention import kernel as dk
    monkeypatch.setattr(dk, "sm_count", lambda index: 132)
    splits, per_split = dk.split_plan(batch, kv_heads, t,
                                      torch.device("cuda", 0), "gemv")
    assert (splits, per_split) == plan
    tiles = -(-t // dk.TILE)
    fewest, most = dk.GEMV_TILES_PER_SPLIT
    assert (splits - 1) * per_split < tiles <= splits * per_split
    assert per_split <= most and (per_split >= fewest or tiles < fewest)
    blocks = batch * kv_heads * splits
    assert blocks >= min(dk.BLOCKS_PER_SM["gemv"] * 132,
                         batch * kv_heads * -(-tiles // fewest))


# -- models/attention.py ------------------------------------------------------------


@pytest.mark.parametrize("s,t,window,q_offset,block_k", [
    (64, 64, None, 0, 512),
    (50, 130, 40, 80, 32),    # padded kv blocks, window, offset
    (33, 33, None, 0, 16),
])
def test_xla_flash_attention_matches(s, t, window, q_offset, block_k):
    rng = np.random.RandomState(120 + t)
    q, k, v = _qkv(rng, 2, 4, 2, s, t, 16)
    want = RA.xla_flash_attention(*_j(q, k, v), causal=True, window=window,
                                  q_offset=q_offset, block_k=block_k)
    got = TA.xla_flash_attention(*_t(q, k, v), causal=True, window=window,
                                 q_offset=q_offset, block_k=block_k)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("r_impl,t_impl", [("pallas", "cuda"), ("xla", "xla"),
                                           ("naive", "naive")])
def test_multihead_attention_impls_match(r_impl, t_impl):
    rng = np.random.RandomState(121)
    q, k, v = _qkv(rng, 1, 4, 2, 64, 64, 32)
    want = RA.multihead_attention(*_j(q, k, v), impl=r_impl, window=24)
    got = TA.multihead_attention(*_t(q, k, v), impl=t_impl, window=24)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-4, atol=2e-4)
    d_want = RA.decode_attention(*_j(q[:, :, 0], k, v),
                                 jnp.asarray([40], jnp.int32),
                                 impl=r_impl, with_lse=True)
    d_got = TA.decode_attention(*_t(q[:, :, 0], k, v),
                                torch.tensor([40], dtype=torch.int32),
                                impl=t_impl, with_lse=True)
    for g, w in zip(d_got, d_want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=2e-4, atol=2e-4)


def test_decode_attention_quant_matches():
    rng = np.random.RandomState(122)
    b, hq, hkv, t, d = 2, 4, 2, 40, 16
    q = _f32(rng, b, hq, d, scale=0.5)
    k_q = rng.randint(-127, 128, (b, hkv, t, d)).astype(np.int8)
    v_q = rng.randint(-127, 128, (b, hkv, t, d)).astype(np.int8)
    k_s = (rng.rand(b, hkv, t) / 100).astype(np.float32)
    v_s = (rng.rand(b, hkv, t) / 100).astype(np.float32)
    kv_len = np.array([7, 40], np.int32)
    want = RA.decode_attention_quant(*_j(q, k_q, k_s, v_q, v_s, kv_len))
    got = TA.decode_attention_quant(*_t(q, k_q, k_s, v_q, v_s, kv_len))
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-4, atol=2e-5)


def test_windowed_decode_matches():
    rng = np.random.RandomState(123)
    q = _f32(rng, 2, 4, 16, scale=0.5)
    k = _f32(rng, 2, 1, 50, 16, scale=0.5)
    v = _f32(rng, 2, 1, 50, 16, scale=0.5)
    kv_len = np.array([10, 50], np.int32)
    want = r_tf._windowed_decode(*_j(q, k, v, kv_len), 16)
    got = t_tf._windowed_decode(*_t(q, k, v, kv_len), 16)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-4, atol=2e-4)

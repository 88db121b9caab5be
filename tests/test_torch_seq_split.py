"""The decode cache split by sequence over ``"model"`` (the reference's
``shard_seq``), piece by piece on one process, on the CPU: each rank's
write of new tokens into its run of positions against the whole cache's,
where a rank's run comes from the cache leaf's own spec, and the
sequence-split attention's partials against the attention on the whole
cache; the same for the hybrid's ring cache (its run of the ring's slots,
through prefills and decode steps across the ring's wrap) and for a dense
sliding window, whose valid positions are not a prefix of a run.  A
rank's coordinates come from a ``ranks.RecordingMesh`` (no collective
runs here; ``tests/test_torch_tp.py`` runs them over gloo ranks against
the reference's GSPMD).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.dist import ranks
from repro_torch.dist.sharding import model_split, seq_run
from repro_torch.launch.rules import rules_for
from repro_torch.models import api, kvcache, rglru, transformer
from repro_torch.models.attention import (
    decode_attention,
    decode_attention_masked,
    decode_attention_quant,
)

T, B = 24, 3


def _rules(arch: str, m: int, rank: int, data: int = 1, **overrides):
    cfg = get_smoke_config(arch).scaled(**overrides)
    mesh = ranks.RecordingMesh({"data": data, "model": m},
                               {"data": 0, "model": rank})
    return cfg, rules_for(cfg, mesh, "tp", shard_seq=True)


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("s,pos", [
    (8, (0, 0, 0)),  # a prefill from 0: straddles the first runs
    (1, (8, 11, 23)),  # decode tokens, each in one run
    (5, (3, 10, 22)),  # a row past the end: its start clamped to 19
    (24, (0, 0, 0)),  # the whole cache at once
])
def test_each_runs_write_equals_its_slice_of_the_whole_caches(m, quant, s,
                                                              pos):
    """``update_layer`` on each rank's run (its buffers of ``T / m``
    positions) leaves exactly that run of the whole cache after the same
    write: tokens that fall outside the run are dropped, a start past
    ``T - S`` is clamped on the whole axis (as ``dynamic_update_slice``
    clamps it), and the rest of the run keeps what it held."""
    over = {"n_kv_heads": 1} if quant else {}  # the heads stay whole
    arch = "qwen1.5-32b" if quant else "gemma-2b"
    g = torch.Generator().manual_seed(3)
    cfg = get_smoke_config(arch).scaled(**over)
    whole = kvcache.init_cache(cfg, B, T, 1, "cpu")
    for v in kvcache.layer_slice(whole).values():  # what the cache held
        v.copy_(torch.randint(-50, 50, v.shape, generator=g).to(v.dtype))
    before = {k: v.clone() for k, v in whole.items()}
    shape = (B, cfg.n_kv_heads, s, cfg.head_dim)
    k_new, v_new = torch.randn(shape, generator=g), torch.randn(shape,
                                                                generator=g)
    p = torch.tensor(pos, dtype=torch.int32)
    want = kvcache.update_layer(cfg, {k: v[0] for k, v in
                                      kvcache.layer_slice(whole).items()},
                                k_new, v_new, p)
    for rank in range(m):
        _, rules = _rules(arch, m, rank, **over)
        n, offset = kvcache.seq_run(rules, T // m)
        assert (n, offset) == (m, rank * T // m)
        run = slice(offset, offset + T // m)
        mine = {k: v[0][:, :, run].clone() for k, v in
                kvcache.layer_slice(before).items()}
        assert kvcache.cache_run(mine, rules) == (n, offset)
        got = kvcache.update_layer(cfg, mine, k_new, v_new, p, (n, offset))
        for name in want:
            assert torch.equal(got[name], want[name][:, :, run]), \
                (m, rank, name)


def test_the_run_comes_from_the_leafs_spec_not_the_rules_axis():
    """phi3's 4 KV heads take "model" first in the cache's spec, so under
    ``shard_seq`` its sequence stays whole although the rules map
    ``kv_seq`` to "model"; gemma-2b's one KV head leaves the axis to the
    sequence: runs of 6 at offsets 0, 6, 12, 18."""
    cfg, rules = _rules("phi3-mini-3.8b", 4, 2)
    assert model_split(rules, "kv_seq") == 4
    assert api.state_specs(cfg, rules)["k"] == (None, "data", "model",
                                                None, None)
    assert kvcache.seq_run(rules, T) == (1, 0)
    assert kvcache.init_cache(cfg, B, T, device="meta",
                              rules=rules)["k"].shape[3] == T
    for rank in range(4):
        cfg, rules = _rules("gemma-2b", 4, rank)
        spec = api.state_specs(cfg, rules)["k"]
        assert spec == (None, "data", None, "model", None)
        assert kvcache.seq_run(rules, 6) == (4, 6 * rank)
        assert seq_run(rules, spec, 3, 6) == (4, 6 * rank)
        assert seq_run(rules, spec, 2, 6) == (1, 0)  # the heads: whole
        cache = kvcache.init_cache(cfg, B, T, device="meta", rules=rules)
        assert cache["k"].shape == (cfg.n_layers, B, 1, 6, cfg.head_dim)
    # the rules alone (no mesh), or a model axis of one rank: whole
    assert kvcache.seq_run(rules_for(cfg, {"data": 1, "model": 4}, "tp",
                                     shard_seq=True)) == (1, 0)
    _, rules = _rules("gemma-2b", 1, 0, data=4)
    assert kvcache.seq_run(rules, T) == (1, 0)


def test_a_run_that_does_not_divide_the_cache_raises():
    cfg, rules = _rules("gemma-2b", 4, 1)
    with pytest.raises(ValueError, match="26 positions .* over 4 ranks"):
        kvcache.init_cache(cfg, B, 26, device="meta", rules=rules)
    cfg, rules = _rules("whisper-medium", 4, 1, n_heads=2, n_kv_heads=2,
                        head_dim=32)
    with pytest.raises(ValueError, match="30 positions .* over 4 ranks"):
        api.init_decode_state(cfg, B, 30, "meta", rules)
    state = api.init_decode_state(cfg, B, 32, "meta", rules)
    assert state["self_k"].shape[3] == 8
    assert state["cross_k"].shape[3] == cfg.enc_frames  # never split


@pytest.mark.parametrize("m", [2, 4])
def test_the_hybrids_ring_run_comes_from_attn_ks_spec(m):
    """Under ``shard_seq`` the smoke hybrid's one KV head leaves "model"
    to the ring's slots: each rank holds ``window / m`` consecutive slots
    of ``attn_k``, ``attn_v`` and ``slot_pos`` (empty, -1); with 4 KV
    heads the spec gives the axis to the heads and the slots, with their
    positions, stay whole; a window ``m`` does not divide raises."""
    win = get_smoke_config("recurrentgemma-2b").window
    for rank in range(m):
        cfg, rules = _rules("recurrentgemma-2b", m, rank)
        specs = api.state_specs(cfg, rules)
        assert specs["attn_k"] == (None, "data", None, "model", None)
        assert specs["slot_pos"] == (None, "data", "model")
        assert rglru.ring_run(cfg, rules) == (m, rank * win // m)
        state = api.init_decode_state(cfg, B, T, "meta", rules)
        g = rglru.n_groups(cfg)[0]
        assert state["attn_k"].shape == (g, B, 1, win // m, cfg.head_dim)
        assert state["slot_pos"].shape == (g, B, win // m)
        state = api.init_decode_state(cfg, B, T, "cpu", rules)
        assert (state["slot_pos"] == -1).all()
    cfg, rules = _rules("recurrentgemma-2b", m, 1, n_kv_heads=4,
                        n_heads=4)
    specs = api.state_specs(cfg, rules)
    assert specs["attn_k"][2:4] == ("model", None)
    assert specs["slot_pos"] == (None, "data", None)
    assert rglru.ring_run(cfg, rules) == (1, 0)
    state = api.init_decode_state(cfg, B, T, "meta", rules)
    assert state["attn_k"].shape[2:4] == (4 // m, win)
    assert state["slot_pos"].shape[2] == win
    cfg, rules = _rules("recurrentgemma-2b", m, 0, window=6 * m + 1)
    with pytest.raises(ValueError,
                       match=f"{6 * m + 1} positions .* over {m} ranks"):
        api.init_decode_state(cfg, B, T, "meta", rules)


#: the hybrid's ring cases: prompt lengths shorter than a run of 4 slots,
#: equal to the smoke window of 16, and longer than it
RING_PROMPTS = {"short": 3, "window": 16, "long": 21}


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("prompt", list(RING_PROMPTS))
def test_each_ranks_ring_holds_its_run_and_its_partials_combine(m, prompt):
    """A prefill's ring (``rglru.ring_cache``) and each decode step's write
    (``rglru.ring_write``) on each rank's run of the smoke window's slots
    equal that run of the whole ring's, through decode steps before and
    across the ring's wrap (slot 15 to 0); at every step, on every rank,
    the attention masked by the run's own ``slot_pos`` (the plain path)
    equals the attention to the first ``clamp(min(pos + 1, window) -
    offset, 0, window / m)`` slots of the run (the kernel path's length:
    the valid slots are a prefix of the run), out and lse, an empty run
    zeros with lse -1e30; and the partials combined equal the attention
    to the whole ring at 1e-5, by its ``slot_pos`` and by its prefix."""
    g = torch.Generator().manual_seed(11)
    win, hq, d, b = 16, 4, 16, 2
    s = RING_PROMPTS[prompt]
    t = win // m
    positions = torch.arange(s, dtype=torch.int32)[None].expand(b, s)
    k, v = (torch.randn(b, 1, s, d, generator=g) for _ in range(2))
    whole = rglru.ring_cache(k, v, positions, win)
    runs = [(m, rank * t) for rank in range(m)]
    mine = [rglru.ring_cache(k, v, positions, win, run) for run in runs]
    empty_seen = False
    # decode positions up to past the next wrap of the ring
    for pos in range(s, s + (win - s % win) + 3):
        p = torch.full((b,), pos, dtype=torch.int32)
        k1, v1 = (torch.randn(b, 1, 1, d, generator=g) for _ in range(2))
        rglru.ring_write(whole, k1, v1, p, win)
        for run, st in zip(runs, mine):
            rglru.ring_write(st, k1, v1, p, win, run)
        q = torch.randn(b, hq, d, generator=g)
        valid = (whole["slot_pos"] >= 0) & (whole["slot_pos"] <= p[:, None])
        want, _ = decode_attention_masked(q, whole["k"], whole["v"], valid)
        kv_len = torch.clamp(p + 1, max=win)
        prefix = decode_attention(q, whole["k"], whole["v"], kv_len,
                                  impl="cuda")
        np.testing.assert_allclose(prefix.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)
        parts = []
        for (_, offset), st in zip(runs, mine):
            run = slice(offset, offset + t)
            for name in ("k", "v", "slot_pos"):
                got, ref = st[name], whole[name]
                ref = ref[:, run] if name == "slot_pos" else ref[:, :, run]
                assert torch.equal(got, ref), (pos, offset, name)
            valid = (st["slot_pos"] >= 0) & (st["slot_pos"] <= p[:, None])
            masked = decode_attention_masked(q, st["k"], st["v"], valid)
            local = torch.clamp(kv_len - offset, 0, t)
            clamped = decode_attention(q, st["k"], st["v"], local,
                                       impl="xla", with_lse=True)
            assert torch.equal(valid.sum(-1), local)
            for a, c in zip(masked, clamped):
                np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=1e-5,
                                           atol=1e-5)
            if (local == 0).any():
                empty_seen = True
                assert not masked[0][local == 0].any()
                assert (masked[1][local == 0] == -1e30).all()
            parts.append(masked)
        np.testing.assert_allclose(_combined(parts).numpy(), want.numpy(),
                                   rtol=1e-5, atol=1e-5)
    # a prompt shorter than a run leaves the later runs empty at first
    assert empty_seen == (prompt == "short")


#: dense sliding windows over a cache of T = 24 (runs of 12 or 6): each
#: case's window and each row's kv_len, the window's first position
#: inside a run, at a run's edge, or past whole runs (which are empty)
WINDOWS = {"inside": (5, (13, 20, 24)),  # from 8, 15, 19 (and 0 below)
           "edge": (6, (18, 24, 4)),  # from 12, 18 and 0
           "past": (3, (16, 20, 24))}  # from 13, 17, 21: run 0 empty


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("quant", [False, True], ids=["plain", "int8"])
@pytest.mark.parametrize("case", list(WINDOWS))
def test_a_windows_split_partials_combine_to_the_windowed_decode(m, quant,
                                                                 case):
    """Each run's attention to the positions of ``[max(kv_len - window,
    0), kv_len)`` it holds (``transformer._window_mask`` at its offset,
    ``decode_attention_masked`` with f32 logits), combined by the lse,
    equals ``transformer._windowed_decode`` on the whole cache at 1e-5;
    a run the window misses is zeros with lse -1e30.  The int8 cache is
    read through ``kvcache.read_layer``, run by run, as the windowed path
    reads it."""
    window, lens = WINDOWS[case]
    kv_len = torch.tensor(lens, dtype=torch.int32)
    g = torch.Generator().manual_seed(13)
    hq, hkv, d = 4, 1, 16
    q = torch.randn(B, hq, d, generator=g)
    if quant:
        cfg = get_smoke_config("qwen1.5-32b").scaled(n_kv_heads=hkv)
        cache = {name: torch.randint(-127, 128, (B, hkv, T, d), generator=g,
                                     dtype=torch.int8)
                 for name in ("k_q", "v_q")}
        cache.update({name: torch.rand(B, hkv, T, generator=g) * 0.02
                      for name in ("k_s", "v_s")})
    else:
        cfg = get_smoke_config("gemma-2b")
        cache = {name: torch.randn(B, hkv, T, d, generator=g)
                 for name in ("k", "v")}
    k, v = kvcache.read_layer(cfg, cache)
    want = transformer._windowed_decode(q, k, v, kv_len, window)
    t = T // m
    parts = []
    for rank in range(m):
        run = slice(rank * t, (rank + 1) * t)
        kr, vr = kvcache.read_layer(cfg, {n: x[:, :, run]
                                          for n, x in cache.items()})
        mask = transformer._window_mask(kv_len, window, rank * t, t)
        out, lse = decode_attention_masked(q, kr, vr, mask)
        empty = ~mask.any(-1)
        assert not out[empty].any() and (lse[empty] == -1e30).all()
        if case == "past" and rank == 0:
            assert empty.all()
        parts.append((out, lse))
    np.testing.assert_allclose(_combined(parts).numpy(), want.numpy(),
                               rtol=1e-5, atol=1e-5)


def _combined(parts):
    """The flash-decode combine of (out, lse) partials, as
    ``combine_decode_partials`` forms it over the ranks."""
    lse = torch.stack([p[1] for p in parts])
    w = torch.exp(lse - lse.amax(0))
    num = sum(p[0].float() * wi[..., None] for p, wi in zip(parts, w))
    return num / w.sum(0)[..., None]


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("quant", [False, True], ids=["plain", "int8"])
def test_split_partials_combine_to_the_whole_caches_attention(m, quant):
    """Each run's attention with its lse, at ``clamp(kv_len - offset, 0,
    T_local)`` valid keys (a run past a row's length gives zeros and lse
    -1e30 there), combined by the lse, equals the attention over the whole
    cache at 1e-5; for the int8 cache by ``decode_attention_quant``'s
    ``with_lse``."""
    g = torch.Generator().manual_seed(5)
    hq, hkv, d = 4, 2, 16
    q = torch.randn(B, hq, d, generator=g)
    kv_len = torch.tensor([1, 13, T], dtype=torch.int32)
    if quant:
        k = torch.randint(-127, 128, (B, hkv, T, d), generator=g,
                          dtype=torch.int8)
        v = torch.randint(-127, 128, (B, hkv, T, d), generator=g,
                          dtype=torch.int8)
        ks, vs = (torch.rand(B, hkv, T, generator=g) * 0.02
                  for _ in range(2))

        def attend(sl, n):
            return decode_attention_quant(q, k[:, :, sl], ks[:, :, sl],
                                          v[:, :, sl], vs[:, :, sl], n,
                                          with_lse=True)
    else:
        k = torch.randn(B, hkv, T, d, generator=g)
        v = torch.randn(B, hkv, T, d, generator=g)

        def attend(sl, n):
            return decode_attention(q, k[:, :, sl], v[:, :, sl], n,
                                    impl="xla", with_lse=True)
    want, want_lse = attend(slice(None), kv_len)
    t = T // m
    parts = []
    for rank in range(m):
        local = torch.clamp(kv_len - rank * t, 0, t)
        out, lse = attend(slice(rank * t, (rank + 1) * t), local)
        empty = local == 0
        assert not out[empty].any()
        assert (lse[empty] == -1e30).all()
        parts.append((out, lse))
    np.testing.assert_allclose(_combined(parts).numpy(), want.numpy(),
                               rtol=1e-5, atol=1e-5)
    # the whole-cache lse is the log of the runs' summed weights
    lse = torch.stack([p[1] for p in parts])
    np.testing.assert_allclose(torch.logsumexp(lse, 0).numpy(),
                               want_lse.numpy(), rtol=1e-5, atol=1e-5)


def test_int8_attention_without_lse_is_unchanged_by_the_lse():
    """``with_lse`` adds the lse and leaves the output as it was."""
    cfg = get_smoke_config("qwen1.5-32b")
    g = torch.Generator().manual_seed(7)
    q = torch.randn(2, cfg.n_heads, cfg.head_dim, generator=g)
    kq = torch.randint(-127, 128, (2, cfg.n_kv_heads, 10, cfg.head_dim),
                       generator=g, dtype=torch.int8)
    ks = torch.rand(2, cfg.n_kv_heads, 10, generator=g)
    n = torch.tensor([4, 10], dtype=torch.int32)
    out = decode_attention_quant(q, kq, ks, kq, ks, n)
    both = decode_attention_quant(q, kq, ks, kq, ks, n, with_lse=True)
    assert torch.equal(out, both[0]) and both[1].shape == (2, cfg.n_heads)

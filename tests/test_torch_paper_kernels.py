"""The paper's section 4.2 benchmarks (Black-Scholes, SpMV-ELL, MD5, N-Body,
Correlator): the port's public functions and launches against the
reference's.

The reference ``ops`` run as the reference's own tests run them on a CPU
(Pallas interpret mode); the port runs on CPU tensors, where each wrapper
takes its plain version.  Inputs come from numpy seeds and reach both sides
as numpy.  Tolerances are those of ``tests/test_kernels.py`` for the same
function: they cover rounding and another order of summation, nothing more;
MD5 is exact.  The CUDA kernels themselves are held against the plain
versions on the GPU by the ``kernels`` phase of ``chip_smoke.py``.
"""

import hashlib
import re
import struct
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
import repro.kernels as RK
import repro_torch.core as T
import repro_torch.kernels as TK
from repro.kernels.md5.ref import md5_u32x2 as r_md5_u32x2
from repro.kernels.nbody.ops import nbody_step as r_nbody_step
from repro_torch.kernels.md5 import ref as t_md5_ref
from repro_torch.kernels.nbody import ref as t_nbody_ref
from repro_torch.kernels.spmv_ell import ref as t_spmv_ref
from repro_torch.kernels.spmv_ell.kernel import lanes_per_row
from repro_torch.kernels.spmv_ell.ref import block_row_bits

from _torch_parity import launch_plan_rows

CSRC = Path(__file__).resolve().parent.parent / "src" / "repro_torch" / "csrc"


def _np(x):
    """A jax or torch array as numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def _bs_inputs(rng, n):
    """The reference sweep's distributions (tests/test_kernels.py:101-103)."""
    s = (5.0 + np.abs(rng.randn(n)) * 25).astype(np.float32)
    k = (1.0 + np.abs(rng.randn(n)) * 99).astype(np.float32)
    t = (0.25 + np.abs(rng.randn(n)) * 9).astype(np.float32)
    return s, k, t


def _spmv_inputs(rng, rows, nnz, n):
    data = rng.rand(rows, nnz).astype(np.float32)
    data *= rng.rand(rows, nnz) < 0.7
    cols = rng.randint(0, n, (rows, nnz)).astype(np.int32)
    x = rng.rand(n).astype(np.float32)
    return data, cols, x


def _digest(key):
    w0 = torch.tensor([key & 0xFFFFFFFF], dtype=torch.int64)
    return tuple(int(v[0]) for v in TK.md5_u32x2(w0, w0 ^ t_md5_ref.KEY_XOR))


# -- Black-Scholes ------------------------------------------------------------


@pytest.mark.parametrize("n", [512, 1000, 8192])
def test_black_scholes_sweep(n):
    s, k, t = _bs_inputs(np.random.RandomState(5000 + n), n)
    want = RK.black_scholes(jnp.asarray(s), jnp.asarray(k), jnp.asarray(t),
                            block=2048)
    got = TK.black_scholes(torch.from_numpy(s), torch.from_numpy(k),
                           torch.from_numpy(t), block=2048)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (n,)
        # erf/log/exp rounding in two frameworks
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-4, atol=2e-4)


def test_black_scholes_put_call_parity():
    n, r = 1024, 0.02
    s, k, t = _bs_inputs(np.random.RandomState(5001), n)
    call, put = TK.black_scholes(torch.from_numpy(s), torch.from_numpy(k),
                                 torch.from_numpy(t), riskfree=r)
    parity = _np(call - put) - (s - k * np.exp(-r * t))
    np.testing.assert_allclose(parity, 0.0, atol=5e-4)


def test_black_scholes_constants_and_use_ref():
    s, k, t = _bs_inputs(np.random.RandomState(5002), 700)
    kw = dict(riskfree=0.05, volatility=0.45)
    want = RK.black_scholes(jnp.asarray(s), jnp.asarray(k), jnp.asarray(t),
                            **kw)
    args = [torch.from_numpy(a) for a in (s, k, t)]
    got = TK.black_scholes(*args, **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-4, atol=2e-4)
    ref = TK.black_scholes(*args, use_ref=True, **kw)
    assert all(torch.equal(a, b) for a, b in zip(ref, got))


# -- SpMV (ELL) ---------------------------------------------------------------


@pytest.mark.parametrize("n,maxnnz", [(512, 8), (300, 16), (1024, 4)])
def test_spmv_sweep(n, maxnnz):
    data, cols, x = _spmv_inputs(np.random.RandomState(6000 + n), n, maxnnz, n)
    want = RK.spmv_ell(jnp.asarray(data), jnp.asarray(cols), jnp.asarray(x),
                       block=128)
    got = TK.spmv_ell(torch.from_numpy(data), torch.from_numpy(cols),
                      torch.from_numpy(x), block=128)
    assert got.shape == (n,) and got.dtype == torch.float32
    # order of a sum of max_nnz terms
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-6)


def _spmv_single_entry(col, n):
    """y[0] of a one-entry row reading column ``col`` of x = 10, 20, ...:
    which x it reads, on the reference kernel, the reference's plain
    version and the port."""
    x = (np.arange(1, n + 1) * 10).astype(np.float32)
    data = np.array([[1.0]], np.float32)
    cols = np.array([[col]], np.int32)
    args = (data, cols, x)
    kernel = float(RK.spmv_ell(*map(jnp.asarray, args))[0])
    r_plain = float(RK.spmv_ell_ref(*map(jnp.asarray, args))[0])
    port = float(TK.spmv_ell(*map(torch.from_numpy, args))[0])
    return kernel, r_plain, port


@pytest.mark.parametrize("col,reads", [
    (0, 10.0), (4, 50.0),             # in range
    (-1, 50.0), (-5, 10.0),           # [-n, 0) wraps: x[c + n]
    (-6, 0.0), (-10, 0.0), (-2**31, 0.0),  # c < -n: fill value 0
    (5, 0.0), (10, 0.0), (2**31 - 1, 0.0),  # c >= n: fill value 0
])
def test_spmv_columns_follow_the_reference_kernel(col, reads):
    """The reference kernel gathers with ``jnp.take(fill_value=0)``; the
    port follows it (not the reference's plain ``x[cols]``, which clamps
    c >= n to x[n - 1])."""
    kernel, r_plain, port = _spmv_single_entry(col, 5)
    assert kernel == reads
    assert port == kernel
    if col >= 5:
        assert r_plain == 50.0  # the trap: the reference oracle clamps


def test_spmv_out_of_range_columns_in_a_matrix():
    """-1, -n, n and n + 5 mixed into the sweep's (300, 16) matrix."""
    n = 300
    data, cols, x = _spmv_inputs(np.random.RandomState(6001), n, 16, n)
    cols[::7, 0] = -1
    cols[1::7, 3] = -n
    cols[2::7, 5] = n
    cols[3::7, 9] = n + 5
    want = RK.spmv_ell(jnp.asarray(data), jnp.asarray(cols), jnp.asarray(x),
                       block=128)
    got = TK.spmv_ell(torch.from_numpy(data), torch.from_numpy(cols),
                      torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-6)
    again = TK.spmv_ell(torch.from_numpy(data), torch.from_numpy(cols),
                        torch.from_numpy(x), use_ref=True)
    assert torch.equal(again, got)


@pytest.mark.parametrize("nnz,vec,lanes", [
    (16, True, 4), (8, True, 2), (4, True, 1), (40, True, 16),
    (5, False, 8), (1, False, 1), (200, False, 32), (0, False, 1)])
def test_spmv_lanes_per_row(nnz, vec, lanes):
    assert lanes_per_row(nnz, vec) == lanes


#: route "bin"'s tiles for the plain version's tests, (slice_bits,
#: block_row_bits): the package's (one tile at these sizes), and small ones
#: that cut the sweep's shapes into several slices and count blocks,
#: ragged at every edge
BIN_TILES = [{}, {"slice_bits": 6, "block_row_bits": 4},
             {"slice_bits": 3, "block_row_bits": 1},
             {"slice_bits": 8, "block_row_bits": 5}]


@pytest.mark.parametrize("tiles", BIN_TILES)
@pytest.mark.parametrize("n,maxnnz", [(512, 8), (300, 16), (1024, 4)])
def test_spmv_binned_ref_matches_the_reference_sweep(n, maxnnz, tiles):
    """Route "bin"'s plain version (the entries binned into tiles, the
    zeros skipped where x is finite) against the reference kernel."""
    data, cols, x = _spmv_inputs(np.random.RandomState(6000 + n), n, maxnnz, n)
    want = RK.spmv_ell(jnp.asarray(data), jnp.asarray(cols), jnp.asarray(x),
                       block=128)
    got = t_spmv_ref.spmv_ell_binned_ref(
        torch.from_numpy(data), torch.from_numpy(cols), torch.from_numpy(x),
        **tiles)
    # another order of a sum of max_nnz terms
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-6)


def _spmv_with_faults(seed, n=300, nnz=16):
    """The sweep's (300, 16) matrix with columns out of range (-1, -n, n,
    n + 5), NaN in x under two zero entries, inf in x under one, and data
    inf and NaN at out-of-range columns."""
    rng = np.random.RandomState(seed)
    data, cols, x = _spmv_inputs(rng, n, nnz, n)
    cols[::7, 0] = -1
    cols[1::7, 3] = -n
    cols[2::7, 5] = n
    cols[3::7, 9] = n + 5
    zeros = np.argwhere(data == 0)
    x[cols[zeros[0][0], zeros[0][1]] % n] = np.nan
    x[cols[zeros[9][0], zeros[9][1]] % n] = np.nan
    x[cols[zeros[20][0], zeros[20][1]] % n] = np.inf
    data[4, 5], cols[4, 5] = np.inf, n + 1
    data[11, 7], cols[11, 7] = np.nan, -n - 2
    return data, cols, x


@pytest.mark.parametrize("tiles", BIN_TILES)
def test_spmv_binned_ref_keeps_nan_and_inf_where_the_reference_has_them(
        tiles):
    """0 * NaN and 0 * inf are NaN: where x holds one, route "bin" bins
    every entry; an out-of-range column reads 0, so inf or NaN data there
    gives NaN.  NaN exactly where the reference kernel has it, the rest
    within the sweep's tolerance."""
    data, cols, x = _spmv_with_faults(6002)
    want = _np(RK.spmv_ell(jnp.asarray(data), jnp.asarray(cols),
                           jnp.asarray(x), block=128))
    got = _np(t_spmv_ref.spmv_ell_binned_ref(
        torch.from_numpy(data), torch.from_numpy(cols), torch.from_numpy(x),
        **tiles))
    assert np.isnan(want).sum() > 10
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-5, atol=1e-6)
    # and route "fma"'s plain version, which gathers every entry
    plain = _np(TK.spmv_ell_ref(*map(torch.from_numpy, (data, cols, x))))
    np.testing.assert_array_equal(np.isnan(plain), np.isnan(want))


@pytest.mark.parametrize("tiles", BIN_TILES[1:])
def test_spmv_binned_ref_with_out_of_range_columns(tiles):
    """-1, -n, n and n + 5 mixed into the sweep's (300, 16) matrix, x
    finite: the fill mode's zeros are skipped, and y is the reference
    kernel's."""
    n = 300
    data, cols, x = _spmv_inputs(np.random.RandomState(6001), n, 16, n)
    cols[::7, 0] = -1
    cols[1::7, 3] = -n
    cols[2::7, 5] = n
    cols[3::7, 9] = n + 5
    want = RK.spmv_ell(jnp.asarray(data), jnp.asarray(cols), jnp.asarray(x),
                       block=128)
    got = t_spmv_ref.spmv_ell_binned_ref(
        torch.from_numpy(data), torch.from_numpy(cols), torch.from_numpy(x),
        **tiles)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("finite", [True, False])
def test_spmv_bins_are_the_kept_entries_segment_by_segment(finite):
    """``bin_entries``: one offset per segment (count block, then slice)
    and one more; each segment's entries decode to rows of its count block
    and columns of its slice; where x is finite only the nonzero entries
    with a column in range are kept, where it is not every entry with a
    column in range is."""
    tiles = {"slice_bits": 6, "block_row_bits": 4}
    data, cols, x = _spmv_inputs(np.random.RandomState(6003), 300, 8, 300)
    cols[::5, 1] = 300  # out of range, finite data: never kept
    if not finite:
        x[7] = np.nan
    offsets, packed, values = t_spmv_ref.bin_entries(
        *map(torch.from_numpy, (data, cols, x)), **tiles)
    slices, count_blocks = 5, 19  # ceil(300 / 64), ceil(300 / 16)
    assert offsets.shape == (slices * count_blocks + 1,)
    assert int(offsets[0]) == 0
    assert bool((offsets[1:] >= offsets[:-1]).all())
    in_range = cols < 300
    kept = in_range & (data != 0) if finite else in_range
    assert int(offsets[-1]) == packed.numel() == int(kept.sum())
    np.testing.assert_array_equal(np.sort(_np(values)), np.sort(data[kept]))
    found = []
    for seg in range(slices * count_blocks):
        lo, hi = int(offsets[seg]), int(offsets[seg + 1])
        words = _np(packed[lo:hi])
        assert ((words >> 6) < 16).all()  # a row of the count block
        block, slice_ = divmod(seg, slices)
        found += zip(block * 16 + (words >> 6), slice_ * 64 + (words & 63),
                     _np(values[lo:hi]))
    rows, js = np.nonzero(kept)
    want = zip(rows, cols[rows, js], data[rows, js])
    assert sorted(found) == sorted(want)


@pytest.mark.parametrize("nnz,bits", [(4, 10), (8, 9), (12, 8), (16, 8),
                                      (64, 6), (4096, 0)])
def test_spmv_count_blocks_hold_at_most_block_entries(nnz, bits):
    """A count block stages its entries in shared memory: as many rows as
    keep them within ``BLOCK_ENTRIES`` (4096)."""
    assert block_row_bits(nnz) == bits
    assert (nnz << bits) <= 4096 < (nnz << (bits + 1))


def test_spmv_binned_ref_refuses_an_empty_x():
    with pytest.raises(ValueError, match="at least one column"):
        t_spmv_ref.bin_entries(torch.zeros((2, 4)),
                               torch.zeros((2, 4), dtype=torch.int32),
                               torch.zeros((0,)))


# -- MD5 ----------------------------------------------------------------------


@pytest.mark.parametrize("v", [0, 1, 255, 123456, 2**31])
def test_md5_matches_hashlib(v):
    w0 = v & 0xFFFFFFFF
    w1 = (v ^ 0x9E3779B9) & 0xFFFFFFFF
    a, b, c, d = TK.md5_u32x2(torch.tensor([w0]), torch.tensor([w1]))
    got = struct.pack("<IIII", int(a[0]), int(b[0]), int(c[0]), int(d[0]))
    assert got == hashlib.md5(struct.pack("<II", w0, w1)).digest()


def test_md5_u32x2_matches_reference_on_random_words():
    rng = np.random.RandomState(7000)
    w0 = rng.randint(0, 2**32, 512, dtype=np.uint64).astype(np.uint32)
    w1 = rng.randint(0, 2**32, 512, dtype=np.uint64).astype(np.uint32)
    want = r_md5_u32x2(jnp.asarray(w0), jnp.asarray(w1))
    got = TK.md5_u32x2(torch.from_numpy(w0.astype(np.int64)),
                       torch.from_numpy(w1.astype(np.int64)))
    for g, w in zip(got, want):
        assert g.dtype == torch.int64
        np.testing.assert_array_equal(_np(g), np.asarray(w, np.int64))


@pytest.mark.parametrize("target_key", [0, 77, 511, 1500])
def test_md5_search(target_key):
    target = _digest(target_key)
    assert int(RK.md5_search(2048, target, block=512)) == target_key
    got = TK.md5_search(2048, target, block=512, device="cpu")
    assert got.dtype == torch.int32 and got.shape == ()
    assert int(got) == target_key
    assert int(TK.md5_search_ref(2048, target, device="cpu")) == target_key


def test_md5_search_no_match():
    assert int(RK.md5_search(256, (1, 2, 3, 4), block=128)) == 256
    assert int(TK.md5_search(256, (1, 2, 3, 4), device="cpu")) == 256
    assert int(TK.md5_search(256, (1, 2, 3, 4), use_ref=True,
                             device="cpu")) == 256


@pytest.mark.parametrize("offset", [0, 1000, 2**31, 2**32 - 100])
def test_md5_search_ref_key_offset(offset):
    """``key_offset`` shifts the hashed keys (with uint32 wrap-around) and
    the result stays an index into [0, n)."""
    target = _digest(offset + 300)
    want = RK.md5_search_ref(512, target, key_offset=offset)
    got = t_md5_ref.md5_search_ref(512, target, key_offset=offset,
                                   device="cpu")
    assert int(got) == int(want) == 300


def test_md5_search_ref_slabs_agree(monkeypatch):
    """The plain version hashes keys a slab at a time; the answer does not
    depend on the slab size."""
    monkeypatch.setattr(t_md5_ref, "SLAB_KEYS", 100)
    for key, n in ((0, 700), (99, 700), (100, 700), (650, 700), (None, 700)):
        target = _digest(key) if key is not None else (1, 2, 3, 4)
        expect = key if key is not None else n
        assert int(t_md5_ref.md5_search_ref(n, target, device="cpu")) \
            == expect


def _md5_listing():
    """The rounds written out in ``csrc/md5.cu``, read as text: each part
    of the listing by its macro's name, as (function, a, b, c, d, word,
    constant, shift) strings."""
    text = (CSRC / "md5.cu").read_text()
    parts = {}
    for name, body in re.findall(
            r"#define (MD5_ROUNDS_\w+)\(STEP\)((?:\s*\\\n\s*STEP\(.*?\))+)",
            text):
        parts[name] = re.findall(
            r"STEP\(MD5_([FGHI]), ([abcd]), ([abcd]), ([abcd]), ([abcd]), "
            r"(\d+), (0x[0-9a-f]+)u, (\d+)\)", body)
    return text, parts


def _function_body(text, signature):
    start = text.index(signature)
    return text[start:text.index("\n}\n", start)]


def test_md5_unwind_gives_the_state_after_round_56():
    """For random keys: the reference's digest unwound through rounds 64-57
    is the state the port's plain steps reach after round 56, and b after
    round 52 plus the second word is the unwound T; hashlib agrees with
    the digest."""
    rng = np.random.RandomState(7001)
    keys = rng.randint(0, 2**32, 64, dtype=np.uint64).astype(np.int64)
    w0 = keys
    w1 = keys ^ t_md5_ref.KEY_XOR
    digest = r_md5_u32x2(jnp.asarray(w0.astype(np.uint32)),
                         jnp.asarray(w1.astype(np.uint32)))
    m = t_md5_ref.md5_message(torch.from_numpy(w0), torch.from_numpy(w1))
    init = tuple(torch.full((64,), v, dtype=torch.int64)
                 for v in t_md5_ref._INIT)
    state52 = t_md5_ref.md5_rounds(init, m, 0, 52)
    state56 = t_md5_ref.md5_rounds(state52, m, 52, 56)
    for i in range(64):
        target = tuple(int(np.asarray(v)[i]) for v in digest)
        assert struct.pack("<IIII", *target) == hashlib.md5(
            struct.pack("<II", int(w0[i]), int(w1[i]))).digest()
        unwound = t_md5_ref.md5_unwind(target)
        assert unwound == tuple(int(v[i]) for v in state56)
        assert t_md5_ref.md5_word1_target(unwound) == (
            int(state52[1][i]) + int(w1[i])) & 0xFFFFFFFF


def test_md5_unround_inverts_every_round():
    rng = np.random.RandomState(7002)
    for i in range(64):
        state = tuple(int(v) for v in rng.randint(0, 2**32, 4,
                                                    dtype=np.uint64))
        word = int(rng.randint(0, 2**32, dtype=np.uint64))
        m = [word] * 16
        after = t_md5_ref.md5_rounds(state, m, i, i + 1)
        assert t_md5_ref.md5_unround(after, i, word) == state


@pytest.mark.parametrize("target_key", [0, 77, 511, 1500, None])
def test_md5_unwound_search_matches_the_reference(target_key):
    """Route "unwind"'s plain version finds the reference kernel's index."""
    n = 2048
    target = _digest(target_key) if target_key is not None else (1, 2, 3, 4)
    want = int(RK.md5_search(n, target, block=512))
    assert want == (target_key if target_key is not None else n)
    got = t_md5_ref.md5_search_unwound_ref(n, target, device="cpu")
    assert got.dtype == torch.int32 and got.shape == ()
    assert int(got) == want


def test_md5_unwound_search_slabs_agree(monkeypatch):
    monkeypatch.setattr(t_md5_ref, "SLAB_KEYS", 100)
    for key in (0, 99, 100, 650):
        assert int(t_md5_ref.md5_search_unwound_ref(700, _digest(key),
                                                    device="cpu")) == key
    assert int(t_md5_ref.md5_search_unwound_ref(700, (1, 2, 3, 4),
                                                device="cpu")) == 700


def test_md5_cuda_rounds_are_rfc_1321():
    """The 64 rounds written out in ``csrc/md5.cu``, read as text: their
    functions, message words, constants, shifts and register order are the
    reference's, and run in Python they give hashlib's digests.  Route
    "fma" runs all three parts of the listing; route "unwind" runs rounds
    1-52 for every key and 53-56 for a key that passes its test, and
    leaves 57-64, which read only constant words, to ``md5_unwind``: a
    key that passes runs rounds 1-56 again in ``md5_state56``."""
    text, parts = _md5_listing()
    assert list(parts) == ["MD5_ROUNDS_1_TO_52", "MD5_ROUNDS_53_TO_56",
                           "MD5_ROUNDS_57_TO_64"]
    assert [len(p) for p in parts.values()] == [52, 4, 8]
    steps = [st for p in parts.values() for st in p]
    assert len(steps) == 64
    order = ["abcd", "dabc", "cdab", "bcda"]
    for i, (fn, *regs, word, k, s) in enumerate(steps):
        assert fn == "FGHI"[i // 16]
        assert "".join(regs) == order[i % 4]
        assert int(word) == t_md5_ref.word_index(i)
        assert int(k, 16) == t_md5_ref._K[i]
        assert int(s) == t_md5_ref._S[i]
    # the last eight rounds read no key word (words 0 and 1)
    assert all(int(st[5]) > 1 for st in parts["MD5_ROUNDS_57_TO_64"])

    fma = _function_body(text, "uint4 md5_u32x2(")
    assert re.findall(r"(MD5_ROUNDS_\w+)\((\w+)\)", fma) == [
        ("MD5_ROUNDS_1_TO_52", "MD5_STEP"),
        ("MD5_ROUNDS_53_TO_56", "MD5_STEP"),
        ("MD5_ROUNDS_57_TO_64", "MD5_STEP")]
    unwind = _function_body(text, "md5_unwind_kernel(")
    assert re.findall(r"(MD5_ROUNDS_\w+)\((\w+)\)", unwind) == [
        ("MD5_ROUNDS_1_TO_52", "MD5_UNWIND_STEP")]
    assert "b[j] + m[j][1] == word1_target" in unwind
    assert "md5_state56(key)" in unwind
    state56 = _function_body(text, "uint4 md5_state56(")
    assert re.findall(r"(MD5_ROUNDS_\w+)\((\w+)\)", state56) == [
        ("MD5_ROUNDS_1_TO_52", "MD5_STEP"),
        ("MD5_ROUNDS_53_TO_56", "MD5_STEP")]

    funcs = {
        "F": lambda b, c, d: (b & c) | (~b & d),
        "G": lambda b, c, d: (d & b) | (~d & c),
        "H": lambda b, c, d: b ^ c ^ d,
        "I": lambda b, c, d: c ^ (b | (~d & 0xFFFFFFFF)),
    }
    mask = 0xFFFFFFFF
    for key in (0, 1, 123456, 2**31 - 1):
        w0, w1 = key, key ^ t_md5_ref.KEY_XOR
        m = [w0, w1, 0x80] + [0] * 11 + [64, 0]
        reg = dict(zip("abcd", t_md5_ref._INIT))
        digest = hashlib.md5(struct.pack("<II", w0, w1)).digest()
        for i, (fn, ra, rb, rc, rd, word, k, s) in enumerate(steps):
            if i == 52:  # route "unwind"'s test after round 52
                assert (reg["b"] + w1) & mask == t_md5_ref.md5_word1_target(
                    t_md5_ref.md5_unwind(struct.unpack("<IIII", digest)))
            if i == 56:  # the state route "unwind" compares
                assert (reg["a"], reg["b"], reg["c"], reg["d"]) == \
                    t_md5_ref.md5_unwind(struct.unpack("<IIII", digest))
            x = (reg[ra] + funcs[fn](reg[rb], reg[rc], reg[rd]) + int(k, 16)
                 + m[int(word)]) & mask
            rot = ((x << int(s)) | (x >> (32 - int(s)))) & mask
            reg[ra] = (reg[rb] + rot) & mask
        out = [(reg[r] + i) & mask for r, i in zip("abcd", t_md5_ref._INIT)]
        assert struct.pack("<IIII", *out) == digest


# -- N-Body -------------------------------------------------------------------


def _bodies(rng, n):
    posm = np.abs(rng.rand(n, 4).astype(np.float32))
    posm[:, 3] += 0.5
    return posm


@pytest.mark.parametrize("n,bi,bj", [(256, 128, 128), (300, 128, 64),
                                     (128, 128, 128)])
def test_nbody_sweep(n, bi, bj):
    posm = _bodies(np.random.RandomState(8000 + n), n)
    want = RK.nbody_forces(jnp.asarray(posm), block_i=bi, block_j=bj)
    got = TK.nbody_forces(torch.from_numpy(posm), block_i=bi, block_j=bj)
    assert got.shape == (n, 3) and got.dtype == torch.float32
    # order of summation over n terms
    np.testing.assert_allclose(_np(got), _np(want), rtol=5e-4, atol=5e-4)


def test_nbody_momentum_conservation():
    """Equal masses: total force ~ 0 (Newton's third law)."""
    n = 128
    posm = np.random.RandomState(8001).rand(n, 4).astype(np.float32)
    posm[:, 3] = 1.0
    acc = _np(TK.nbody_forces(torch.from_numpy(posm), block_i=64,
                              block_j=64))
    np.testing.assert_allclose(acc.sum(axis=0), 0.0, atol=2e-2)


def test_nbody_softening_and_step():
    rng = np.random.RandomState(8002)
    posm = _bodies(rng, 200)
    vel = (rng.randn(200, 3) * 0.1).astype(np.float32)
    want = RK.nbody_forces(jnp.asarray(posm), softening2=1e-2)
    got = TK.nbody_forces(torch.from_numpy(posm), softening2=1e-2)
    np.testing.assert_allclose(_np(got), _np(want), rtol=5e-4, atol=5e-4)
    rp, rv = jnp.asarray(posm), jnp.asarray(vel)
    tp, tv = torch.from_numpy(posm), torch.from_numpy(vel)
    for _ in range(3):
        rp, rv = r_nbody_step(rp, rv, dt=0.001, block_i=128, block_j=128)
        tp, tv = TK.nbody_step(tp, tv, dt=0.001, block_i=128, block_j=128)
    # three steps of the sweep's force tolerance, scaled by dt
    np.testing.assert_allclose(_np(tp), _np(rp), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(tv), _np(rv), rtol=5e-4, atol=5e-4)
    np.testing.assert_array_equal(_np(tp)[:, 3], posm[:, 3])
    ref = TK.nbody_step(torch.from_numpy(posm), torch.from_numpy(vel),
                        use_ref=True)
    assert all(torch.equal(a, b) for a, b in zip(
        ref, TK.nbody_step_ref(torch.from_numpy(posm), torch.from_numpy(vel))))


def test_nbody_ref_slabs_and_rows(monkeypatch):
    """Targets taken in slabs, or a range of them, give the same rows."""
    posm = torch.from_numpy(_bodies(np.random.RandomState(8003), 300))
    whole = TK.nbody_forces_ref(posm)
    np.testing.assert_allclose(
        _np(TK.nbody_forces_ref(posm, rows=(100, 164))), _np(whole[100:164]),
        rtol=1e-6, atol=1e-6)
    monkeypatch.setattr(t_nbody_ref, "SLAB_ELEMENTS", 3 * 300 * 7)
    np.testing.assert_allclose(_np(TK.nbody_forces_ref(posm)), _np(whole),
                               rtol=1e-6, atol=1e-6)
    assert TK.nbody_forces_ref(posm, rows=(5, 5)).shape == (0, 3)


def _term_scale(posm, softening2=t_nbody_ref.SOFTENING2):
    """sum_j |term_ij| per target and axis, in float64: the size an N-Body
    sum is held against (``chip_smoke.nbody_slab_check``)."""
    p = posm.astype(np.float64)
    d = p[None, :, :3] - p[:, None, :3]
    dist2 = (d * d).sum(-1) + softening2
    return np.einsum("ij,ijk->ik", p[None, :, 3] / dist2 ** 1.5, np.abs(d))


def _nbody_sliced_inputs(n):
    """The sweep's bodies with every 7th mass zero."""
    posm = _bodies(np.random.RandomState(8100 + n), n)
    posm[::7, 3] = 0.0
    return posm


@pytest.mark.parametrize("slices,tile", [(4, 256), (3, 64), (2, 128),
                                         (5, 32)])
@pytest.mark.parametrize("n", [300, 1000])
def test_nbody_sliced_ref_matches_the_reference(n, slices, tile):
    """Route "tile"'s order of summation (each slice of sources, then the
    slices in order) against the reference's Pallas kernel, within 1e-4 of
    sum |term|: ragged last slices and tiles, zero masses."""
    posm = _nbody_sliced_inputs(n)
    ranges = t_nbody_ref.nbody_slices(n, slices, tile)
    assert ranges[0][0] == 0 and ranges[-1][1] == n
    assert all(hi - lo == ranges[0][1] - ranges[0][0] for lo, hi in
               ranges[:-1]) and (ranges[0][1] % tile == 0)
    assert [hi for _, hi in ranges[:-1]] == [lo for lo, _ in ranges[1:]]
    want = _np(RK.nbody_forces(jnp.asarray(posm), block_i=100,
                               block_j=100))
    got = _np(t_nbody_ref.nbody_sliced_ref(torch.from_numpy(posm),
                                           slices=slices, tile=tile))
    assert np.all(np.abs(got - want) <= 1e-4 * _term_scale(posm))
    # a slice's partial is the plain version over its sources
    lo, hi = ranges[-1]
    part = _np(TK.nbody_forces_ref(torch.from_numpy(posm), cols=(lo, hi)))
    alone = _np(TK.nbody_forces_ref(torch.from_numpy(posm[lo:hi])))
    np.testing.assert_allclose(part[lo:hi], alone, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [300, 1000])
def test_nbody_planted_faults_fail_the_limit(n, monkeypatch):
    """``chip_smoke.nbody_faults``: a slice's partial dropped, and the last
    ragged source tile skipped; each is off the reference by more than
    1e-4 of sum |term|, the limit route "tile" is held to."""
    monkeypatch.syspath_prepend(str(CSRC.parents[2]))
    import chip_smoke

    posm = _nbody_sliced_inputs(n)
    want = _np(RK.nbody_forces(jnp.asarray(posm), block_i=100, block_j=100))
    scale = _term_scale(posm)
    faults = chip_smoke.nbody_faults(torch.from_numpy(posm))
    assert set(faults) == {"slice_partial_dropped", "ragged_tile_skipped"}
    for label, bad in faults.items():
        assert np.any(np.abs(_np(bad) - want) > 1e-4 * scale), label
    rows = chip_smoke.nbody_fault_rows(torch.from_numpy(posm))
    assert [r["fault"] for r in rows] == list(faults)


def test_nbody_eps_zero_is_nan_everywhere_as_in_the_reference():
    """eps^2 = 0: every target's self term is 0 * inf, NaN in the reference
    and in the plain version alike (route "fma" keeps it so)."""
    posm = _bodies(np.random.RandomState(8004), 64)
    want = _np(RK.nbody_forces(jnp.asarray(posm), softening2=0.0))
    got = _np(TK.nbody_forces(torch.from_numpy(posm), softening2=0.0))
    assert np.isnan(want).all() and np.isnan(got).all()


# -- Correlator ---------------------------------------------------------------


def _samples(seed, c, t, a):
    """The reference sweep's samples: normal with std 0.5."""
    return (np.random.RandomState(seed).randn(c, t, a, 2) * 0.5).astype(
        np.float32)


@pytest.mark.parametrize("c,t,a", [(4, 100, 16), (2, 64, 8), (1, 200, 32)])
def test_correlator_sweep(c, t, a):
    s = _samples(9500 + t, c, t, a)
    want = RK.correlate(jnp.asarray(s), block_t=32)
    got = TK.correlate(torch.from_numpy(s), block_t=32)
    assert got.shape == (c, a, a, 2) and got.dtype == torch.float32
    # order of a sum of 4 t products
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)


def test_correlator_hermitian():
    v = _np(TK.correlate(torch.from_numpy(_samples(9501, 2, 64, 8))))
    # V[i,j] = conj(V[j,i])
    np.testing.assert_allclose(v[..., 0], v[..., 0].transpose(0, 2, 1),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(v[..., 1], -v[..., 1].transpose(0, 2, 1),
                               rtol=1e-4, atol=1e-4)
    # the diagonal is the real power of each antenna
    np.testing.assert_allclose(np.diagonal(v[..., 1], axis1=1, axis2=2), 0.0,
                               atol=1e-5)


@pytest.mark.parametrize("t,block_t", [(77, 32), (33, 512)])
def test_correlator_ragged_time(t, block_t):
    """T not a multiple of the time block: the reference pads with zeros,
    the port's kernel masks; the plain version takes all of T."""
    s = _samples(9502, 3, t, 12)
    want = RK.correlate(jnp.asarray(s), block_t=block_t)
    got = TK.correlate(torch.from_numpy(s), block_t=block_t)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)
    assert torch.equal(TK.correlate(torch.from_numpy(s), use_ref=True), got)


def test_correlator_bf16_samples_sum_in_f32_like_the_reference():
    """bf16 samples give bf16 visibilities, as the reference's do; both lie
    within 2^-8 (2 |want| + 8 rms) of the f32 sums of the same bf16 values,
    the limit the GPU kernel is held to in bf16."""
    s = torch.from_numpy(_samples(9503, 2, 77, 12)).to(torch.bfloat16)
    want = _np(TK.correlate(s.float()))
    got = TK.correlate(s)
    assert got.shape == (2, 12, 12, 2) and got.dtype == torch.bfloat16
    ref = RK.correlate(jnp.asarray(s.float().numpy(), jnp.bfloat16),
                       block_t=32)
    assert ref.dtype == jnp.bfloat16
    rms = np.sqrt(np.mean(want ** 2))
    limit = 2.0 ** -8 * (2 * np.abs(want) + 8 * rms)
    for out in (_np(got.float()), np.asarray(ref, np.float32)):
        assert (np.abs(out - want) <= limit).all()


# -- the four benchmarks through Context.launch -------------------------------

ANNOTATIONS = {
    "black_scholes": "global i => read price[i], read strike[i], "
                     "read years[i], write call[i], write put[i]",
    "spmv_ell": "global i => read data[i,:], read cols[i,:], read x[:], "
                "write y[i]",
    "md5": "global i => reduce(min) found[:]",
    "nbody": "global i => read posm[:,:], write acc[i,:]",
    "correlate": "global c => read samples[c,:,:,:], write vis[c,:,:,:]",
}


def _launch(mod, kern, name, arrays, grid, work, comm, scalars=None):
    """One launch of benchmark ``name`` on one side: returns its outputs as
    numpy and the launch's plan rows."""
    to_arr = jnp.asarray if mod is R else torch.from_numpy
    ctx = mod.Context() if mod is R else mod.Context(device="cpu")
    bodies = {
        "black_scholes": lambda v, i: dict(zip(("call", "put"), (
            kern.black_scholes(v["price"], v["strike"], v["years"])))),
        "spmv_ell": lambda v, i: {"y": kern.spmv_ell(
            v["data"], v["cols"], v["x"], block=128)},
        "md5": lambda v, i: {"found": kern.md5_search(
            i.grid[0], i.scalars["target"], block=512,
            **({} if mod is R else {"device": v["found"].device})
        ).reshape(1)},
        "nbody": lambda v, i: {"acc": kern.nbody_forces(
            v["posm"], block_i=128, block_j=128)},
        "correlate": lambda v, i: {"vis": kern.correlate(v["samples"],
                                                         block_t=32)},
    }
    kdef = mod.KernelDef.define(name, bodies[name], ANNOTATIONS[name],
                                scalars=tuple(scalars or ()))
    args = {}
    for arg, (value, dist) in arrays.items():
        d = None if dist is None else getattr(mod, dist[0])(*dist[1:])
        if isinstance(value, tuple):  # (shape, fill, dtype name)
            shape, fill, dtype = value
            args[arg] = ctx.full(shape, fill, dtype=getattr(
                jnp if mod is R else torch, dtype), dist=d, name=arg)
        else:
            args[arg] = ctx.array(to_arr(value), dist=d, name=arg)
    res = ctx.launch(kdef, grid=grid, args=args,
                     work_dist=getattr(mod, work[0])(*work[1:]),
                     scalars=scalars)
    assert {a: p.value for a, p in ctx.records[-1].comm.items()} == comm
    outs = {k: np.asarray(v.value) if mod is R else v.value.numpy()
            for k, v in res.items()}
    return outs, launch_plan_rows(ctx.records[-1].plan)


def _both(name, arrays, grid, work, comm, scalars=None):
    (r_out, r_plan), (t_out, t_plan) = (
        _launch(mod, kern, name, arrays, grid, work, comm, scalars)
        for mod, kern in ((R, RK), (T, TK)))
    assert t_plan == r_plan  # task by task
    assert set(t_out) == set(r_out)
    return r_out, t_out


def test_black_scholes_through_launch():
    n = 4096
    s, k, t = _bs_inputs(np.random.RandomState(9000), n)
    dist = ("BlockDist", n // 8)
    zeros = ((n,), 0.0, "float32")
    want, got = _both(
        "black_scholes",
        {"price": (s, dist), "strike": (k, dist), "years": (t, dist),
         "call": (zeros, dist), "put": (zeros, dist)},
        (n,), ("BlockWork", n // 8),
        dict.fromkeys(("price", "strike", "years", "call", "put"), "local"))
    for key in ("call", "put"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=2e-4)


def test_spmv_through_launch():
    rows = 1024
    data, cols, x = _spmv_inputs(np.random.RandomState(9001), rows, 16, rows)
    want, got = _both(
        "spmv_ell",
        {"data": (data, ("RowDist", 8)), "cols": (cols, ("RowDist", 8)),
         "x": (x, None), "y": (((rows,), 0.0, "float32"), ("RowDist", 8))},
        (rows,), ("BlockWork", rows // 8),
        {"data": "local", "cols": "local", "x": "replicated", "y": "local"})
    np.testing.assert_allclose(got["y"], want["y"], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("key", [1500, 0, None])
def test_md5_through_launch(key):
    n = 2048
    target = _digest(key) if key is not None else (1, 2, 3, 4)
    want, got = _both(
        "md5", {"found": (((1,), n, "int32"), None)},
        (n,), ("BlockWork", n // 8), {"found": "reduce"},
        scalars={"target": target})
    assert got["found"].dtype == np.int32
    np.testing.assert_array_equal(got["found"], want["found"])
    assert int(got["found"][0]) == (key if key is not None else n)


def test_nbody_through_launch():
    n = 256
    posm = _bodies(np.random.RandomState(9002), n)
    want, got = _both(
        "nbody",
        {"posm": (posm, None),
         "acc": (((n, 3), 0.0, "float32"), ("RowDist", 8))},
        (n,), ("BlockWork", n // 8), {"posm": "replicated", "acc": "local"})
    np.testing.assert_allclose(got["acc"], want["acc"], rtol=5e-4, atol=5e-4)


def test_correlator_through_launch():
    """Channels distributed, each superblock correlates its own."""
    c, t, a = 16, 40, 8
    s = _samples(9003, c, t, a)
    want, got = _both(
        "correlate",
        {"samples": (s, ("RowDist", 8)),
         "vis": (((c, a, a, 2), 0.0, "float32"), ("RowDist", 8))},
        (c,), ("BlockWork", c // 8), {"samples": "local", "vis": "local"})
    np.testing.assert_allclose(got["vis"], want["vis"], rtol=1e-4, atol=1e-4)

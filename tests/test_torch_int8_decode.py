"""Decode attention on the int8 KV cache against the reference's, on the
CPU.

The reference's ``decode_attention_quant`` (its XLA-fused form) runs as its
own tests run it; the port's ``models.attention.decode_attention_quant``
runs on CPU tensors, where it takes the plain version
(``kernels.decode_attention.ref.decode_attention_quant_ref``); the CUDA
kernel (``csrc/decode_attention_int8.cu``) is held against that plain
version on the GPU by ``chip_smoke.py``'s ``kernels`` and ``serve``
phases.  Inputs come from numpy seeds.  Tolerances: f32 rtol 2e-4 and atol
2e-5, as ``tests/test_torch_attention.py``'s int8 case (another order of
summation, values of about 1e-2); bf16 3e-2, the reference sweep's bf16
limit (``tests/test_kernels.py``).  A row with ``kv_len`` 0 has no usable
reference value (its softmax is 0 / 0), so it is checked on its own: zeros
and lse -1e30, as the decode kernel gives.
"""

import dataclasses
import importlib
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as RA
import repro_torch.models.attention as TA
from repro.configs import get_smoke_config as r_smoke
from repro.models import api as r_api
from repro_torch.convert import config_from_reference, params_from_reference
from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.ref import (
    EMPTY_LSE,
    decode_attention_quant_ref,
    decode_attention_ref,
)
from repro_torch.models import api as t_api
from repro_torch.models import transformer as t_tf

decode_kernel = importlib.import_module(
    "repro_torch.kernels.decode_attention.kernel")
CSRC = Path(__file__).resolve().parent.parent / "src" / "repro_torch" / "csrc"
TOL = {np.float32: (2e-4, 2e-5), "bfloat16": (3e-2, 3e-2)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _inputs(seed, b, hq, hkv, t, d, kv_len):
    """q (b, hq, d) normal with std 0.5; the cache as the reference's
    ``kvcache`` quantizes normal keys and values: int8 entries in [-127,
    127] with per-token scales max |x| / 127."""
    rng = np.random.RandomState(seed)
    q = (0.5 * rng.randn(b, hq, d)).astype(np.float32)

    def quantized():
        x = rng.randn(b, hkv, t, d).astype(np.float32)
        s = np.abs(x).max(-1) / 127.0
        xq = np.clip(np.round(x / s[..., None]), -127, 127).astype(np.int8)
        return xq, s.astype(np.float32)

    (k_q, k_s), (v_q, v_s) = quantized(), quantized()
    return q, k_q, k_s, v_q, v_s, np.asarray(kv_len, np.int32)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


#: (B, HQ, HKV, T, D) and kv_len: a group of 1 (qwen1.5-32b's MHA), 4 and
#: 6, D = 64, 80 and 128, T not a multiple of the kernel's 64-key tile,
#: rows at kv_len 1 and T
CASES = [
    ("qwen's MHA, D = 128", (2, 4, 4, 150, 128), [150, 37]),
    ("group 6, D = 128", (2, 12, 2, 70, 128), [1, 70]),
    ("group 6, D = 80", (3, 6, 1, 100, 80), [64, 65, 100]),
    ("group 4, D = 64", (2, 8, 2, 200, 64), [129, 200]),
    ("group 1, D = 64, T < a tile", (1, 2, 2, 40, 64), [23]),
]


@pytest.mark.parametrize("what,shape,kv_len", CASES,
                         ids=[c[0] for c in CASES])
def test_plain_version_matches_the_reference(what, shape, kv_len):
    q, k_q, k_s, v_q, v_s, n = _inputs(31, *shape, kv_len)
    want = RA.decode_attention_quant(*_j(q, k_q, k_s, v_q, v_s, n))
    got = TA.decode_attention_quant(*_t(q, k_q, k_s, v_q, v_s, n))
    assert got.shape == shape[:2] + shape[-1:] and got.dtype == torch.float32
    rtol, atol = TOL[np.float32]
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol,
                               err_msg=what)


@pytest.mark.parametrize("what,shape,kv_len", CASES[:3],
                         ids=[c[0] for c in CASES[:3]])
def test_plain_version_matches_the_reference_in_bf16(what, shape, kv_len):
    """A bf16 q (the serving dtype, the kernel's route "mma"): both round
    p * v_s to bf16 before the second product."""
    q, k_q, k_s, v_q, v_s, n = _inputs(32, *shape, kv_len)
    want = RA.decode_attention_quant(jnp.asarray(q, jnp.bfloat16),
                                     *_j(k_q, k_s, v_q, v_s, n))
    got = TA.decode_attention_quant(torch.from_numpy(q).bfloat16(),
                                    *_t(k_q, k_s, v_q, v_s, n))
    assert got.dtype == torch.bfloat16
    rtol, atol = TOL["bfloat16"]
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol,
                               err_msg=what)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_an_empty_row_gives_zeros_and_the_empty_lse(dtype):
    """A row with no valid key (a rank's run of a sequence-split cache past
    a short row) gives zeros and lse -1e30, so that a combine of partials
    gives it weight 0; the rows with keys match the reference, and their
    lse is the log of their softmax's denominator."""
    q, k_q, k_s, v_q, v_s, n = _inputs(33, 3, 6, 1, 130, 128, [0, 1, 130])
    out, lse = TA.decode_attention_quant(
        torch.from_numpy(q).to(dtype), *_t(k_q, k_s, v_q, v_s, n),
        with_lse=True)
    assert lse.shape == (3, 6) and lse.dtype == torch.float32
    assert not out[0].any()
    assert (lse[0] == EMPTY_LSE).all()
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    want = RA.decode_attention_quant(jnp.asarray(q[1:]).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32),
        *_j(k_q[1:], k_s[1:], v_q[1:], v_s[1:], n[1:]))
    rtol, atol = TOL[np.float32 if dtype == torch.float32 else "bfloat16"]
    np.testing.assert_allclose(_np(out[1:]), _np(want), rtol=rtol, atol=atol)
    # lse of the rows with keys: logsumexp of k_s * scale * (q . k_q)
    logits = np.einsum("bhd,btd->bht", _np(torch.from_numpy(q).to(dtype)),
                       k_q[:, 0].astype(np.float32)) \
        * k_s[:, 0, None, :] / np.sqrt(128)
    for row in (1, 2):
        want_lse = np.log(np.exp(logits[row, :, :n[row]].astype(np.float64))
                          .sum(-1))
        np.testing.assert_allclose(_np(lse[row]), want_lse, rtol=1e-5,
                                   atol=1e-5)


def test_plain_version_is_attention_on_the_dequantized_cache():
    """The identity the card's checks rest on (``chip_smoke.py``
    ``quant_decode_plain``): in f32 the plain version equals the decode
    attention's plain version on k_q * k_s and v_q * v_s, lse included."""
    q, k_q, k_s, v_q, v_s, n = _t(*_inputs(34, 3, 12, 2, 150, 64,
                                           [0, 77, 150]))
    got = decode_attention_quant_ref(q, k_q, k_s, v_q, v_s, n, with_lse=True)
    want = decode_attention_ref(q, k_q.float() * k_s[..., None],
                                v_q.float() * v_s[..., None], kv_len=n,
                                with_lse=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("impl", ["xla", "naive", "cuda"])
def test_a_cpu_tensor_or_another_impl_takes_the_plain_version(
        impl, monkeypatch):
    """On a CPU tensor every ``impl`` takes the plain version and never
    touches the build or the kernel's counter."""
    def refuse(*a, **k):
        raise AssertionError("the build was touched for a CPU tensor")

    for name in ("build", "load", "bind", "find_nvcc"):
        monkeypatch.setattr(_build, name, refuse)
    wrapper = decode_kernel.decode_attention_quant_cuda
    before = (wrapper.launches, dict(wrapper.routes))
    args = _t(*_inputs(35, 2, 4, 4, 70, 64, [5, 70]))
    got = TA.decode_attention_quant(*args, impl=impl, with_lse=True)
    want = decode_attention_quant_ref(*args, with_lse=True)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (wrapper.launches, wrapper.routes) == before


def test_impl_other_than_cuda_takes_the_plain_version_off_the_cpu():
    """A tensor off the CPU (here the meta device) goes to the kernel's
    wrapper with ``impl`` "cuda", which refuses what is not a CUDA tensor:
    no fallback; with another ``impl`` it takes the plain version."""
    args = [x.to("meta") for x in _t(*_inputs(36, 2, 4, 4, 70, 64, [5, 70]))]
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        TA.decode_attention_quant(*args)
    for impl in ("xla", "naive"):
        out, lse = TA.decode_attention_quant(*args, impl=impl, with_lse=True)
        assert out.device.type == "meta" and out.shape == (2, 4, 64)
        assert lse.shape == (2, 4)


def test_the_wrapper_refuses_cpu_tensors():
    args = _t(*_inputs(37, 1, 2, 2, 10, 16, [10]))
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        decode_kernel.decode_attention_quant_cuda(*args)


def test_the_kernels_tile_is_the_wrappers():
    """The wrapper's split plan counts in the sources' 64-key tiles (route
    "gemv"'s own among them), and each of its routes has its C entry
    point."""
    header = (CSRC / "decode_attention.cuh").read_text()
    assert int(re.search(r"constexpr int BT = (\d+);", header).group(1)) \
        == decode_kernel.TILE
    source = "".join((CSRC / name).read_text() for name in (
        "decode_attention_int8.cu", "decode_attention_int8_gemv.cu"))
    tiles = re.findall(r"constexpr int BT = (\d+);", source)
    assert tiles and all(int(n) == decode_kernel.TILE for n in tiles)
    for route in decode_kernel.QUANT_ROUTES:
        entry = decode_kernel._QUANT_SYMBOLS[route]
        assert f'extern "C" int {entry}(' in source
    assert source.count("Replaces no `pallas_call`") == 2


def _pair(impl):
    rcfg = dataclasses.replace(r_smoke("qwen1.5-32b"), attention_impl="xla")
    rparams = r_api.init_params(jax.random.key(0), rcfg)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), rparams)
    tcfg = dataclasses.replace(config_from_reference(rcfg),
                               attention_impl=impl)
    return rcfg, rparams, tcfg, params_from_reference(tree, tcfg, "cpu")


@pytest.mark.parametrize("impl", ["cuda", "xla"])
def test_qwens_decode_steps_attend_on_the_int8_cache(impl, monkeypatch):
    """The slice as a whole: qwen1.5-32b's smoke config (the int8 cache,
    fused) prefills and decodes three steps as the reference does (logits
    at 1e-4, as ``tests/test_torch_models.py``), each step calling
    ``decode_attention_quant`` once a layer with the config's
    ``attention_impl``."""
    rcfg, rparams, tcfg, tparams = _pair(impl)
    assert tcfg.kv_quant and tcfg.kv_fused
    calls = []
    quant = t_tf.decode_attention_quant

    def spy(*args, **kw):
        calls.append(kw.get("impl"))
        return quant(*args, **kw)

    monkeypatch.setattr(t_tf, "decode_attention_quant", spy)
    rng = np.random.RandomState(38)
    b, s, max_len = 2, 9, 24
    toks = rng.randint(0, rcfg.vocab, (b, s)).astype(np.int32)
    rstate = r_api.init_decode_state(rcfg, b, max_len)
    tstate = t_api.init_decode_state(tcfg, b, max_len, "cpu")
    _, rstate = r_api.prefill(rparams, {"tokens": jnp.asarray(toks)}, rcfg,
                              rstate)
    _, tstate = t_api.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                              tcfg, tstate)
    for step in range(3):
        tok = rng.randint(0, rcfg.vocab, (b, 1)).astype(np.int32)
        rlog, rstate = r_api.decode_step(rparams, jnp.asarray(tok), rcfg,
                                         rstate)
        tlog, tstate = t_api.decode_step(tparams, torch.from_numpy(tok),
                                         tcfg, tstate)
        np.testing.assert_allclose(_np(tlog), _np(rlog), rtol=1e-4,
                                   atol=1e-4, err_msg=f"decode step {step}")
    assert calls == [impl] * (3 * tcfg.n_layers)


@pytest.mark.parametrize("impl", ["cuda", "xla"])
def test_the_sequence_split_int8_decode_passes_its_impl(impl, monkeypatch):
    """A rank's part of the int8 decode over a cache split by sequence
    attends to its run with its own ``impl``."""
    seen = []

    def spy(*args, **kw):
        seen.append((kw.get("impl"), kw.get("with_lse")))
        raise StopIteration

    monkeypatch.setattr(TA, "decode_attention_quant", spy)
    q, k_q, k_s, v_q, v_s, n = _t(*_inputs(39, 2, 4, 4, 12, 16, [3, 12]))
    with pytest.raises(StopIteration):
        TA.decode_attention_seq_split(q, k_q, v_q, n, 6, impl=impl,
                                      scales=(k_s, v_s))
    assert seen == [(impl, True)]


def test_the_probes_variants_find_their_lines_in_the_source():
    """``tools/int8_decode_probe.py`` builds its ablation of routes "mma"
    and "gemv" from copies of the source edited line by line, and
    ``tools/decode_splits.py`` its group sweep's build with an instance of 8
    heads: every line they edit is in the source once, so that a change of
    the kernel cannot leave a variant unedited."""
    import importlib.util
    import sys

    root = Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root))
    try:
        mods = {}
        for name in ("int8_decode_probe", "decode_splits"):
            spec = importlib.util.spec_from_file_location(
                name, root / "tools" / f"{name}.py")
            mods[name] = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mods[name])
    finally:
        sys.path.remove(str(root))
    probe = mods["int8_decode_probe"]
    for variants, path in ((probe.VARIANTS, probe.SOURCE),
                           (probe.GEMV_VARIANTS, probe.GEMV_SOURCE)):
        source = path.read_text()
        for olds, _ in variants.values():
            for old, _ in olds:
                assert source.count(old) == 1, old
        for entry in probe.ENTRIES:
            assert source.count(f'extern "C" int {entry}(') <= 1
    assert probe.GEMV_SOURCE.read_text().count(
        mods["decode_splits"]._DISPATCH) == 1

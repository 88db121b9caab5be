"""The port's serving engine and driver against the reference's.

Both engines get the same parameters (the reference's from a JAX key,
carried over through ``repro_torch.convert``) and the same prompts (numpy
seeds), and run on the CPU.  Greedy tokens, statuses, ``stats`` and the
``serve.*`` metrics must be equal; logits agree within 1e-4 (the models'
parity tests), far inside the gaps between the top logits of these
prompts.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as r_smoke
from repro.core import faults as r_faults
from repro.launch.serve import run_serving as r_run_serving
from repro.models import api as r_api
from repro.obs.metrics import MetricsRegistry as RRegistry
from repro.serve.engine import Request as RRequest
from repro.serve.engine import ServeEngine as REngine
from repro.serve.engine import _splice_state as r_splice_state
from repro_torch.convert import config_from_reference, params_from_reference
from repro_torch.core import faults as t_faults
from repro_torch.launch.serve import run_serving
from repro_torch.models import api as t_api
from repro_torch.obs.metrics import MetricsRegistry as TRegistry
from repro_torch.serve.engine import Request, ServeEngine, _splice_state


def _both(arch, seed):
    rcfg = r_smoke(arch)
    rparams = r_api.init_params(jax.random.key(seed), rcfg)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), rparams)
    tcfg = config_from_reference(rcfg)
    return rcfg, rparams, tcfg, params_from_reference(tree, tcfg, "cpu")


@pytest.fixture(scope="module")
def gemma():
    return _both("gemma-2b", 0)


def _serve(engines, prompts, **req_kw):
    """Submit the same requests to the reference and the port engine; run
    both; their requests by rid."""
    out = []
    for eng, req_cls in zip(engines, (RRequest, Request)):
        for rid, (p, kw) in enumerate(prompts):
            eng.submit(req_cls(rid=rid, prompt=p, **{**req_kw, **kw}))
        out.append({r.rid: r for r in eng.run(max_steps=60)})
    return out


def _same(r_done, t_done):
    assert sorted(r_done) == sorted(t_done)
    for rid in r_done:
        assert t_done[rid].status == r_done[rid].status, rid
        assert t_done[rid].output == r_done[rid].output, rid
        assert t_done[rid].done


def test_engine_completes_all_requests():
    """The reference's ``test_engine_completes_all_requests`` on the port."""
    _, _, cfg, params = _both("phi3-mini-3.8b", 0)
    engine = ServeEngine(params, cfg, slots=2, max_len=64, device="cpu")
    rng = np.random.default_rng(0)
    for rid in range(5):
        engine.submit(Request(
            rid=rid, prompt=rng.integers(0, cfg.vocab, 12).astype(np.int32),
            max_new_tokens=6))
    done = engine.run()
    assert len(done) == 5
    assert all(len(r.output) == 6 and r.status == "ok" for r in done)
    assert engine.stats["decode_tokens"] > 0


@pytest.mark.parametrize("arch,seed,slots,plen", [("gemma-2b", 1, 3, 10),
                                                  ("phi3-mini-3.8b", 0, 2, 12)])
def test_greedy_tokens_equal_the_reference_engine(arch, seed, slots, plen):
    rcfg, rparams, tcfg, tparams = _both(arch, seed)
    rng = np.random.default_rng(seed)
    prompts = [(rng.integers(0, rcfg.vocab, plen + i).astype(np.int32),
                {"max_new_tokens": 3 + 2 * i}) for i in range(5)]
    r_done, t_done = _serve(
        [REngine(rparams, rcfg, slots=slots, max_len=64),
         ServeEngine(tparams, tcfg, slots=slots, max_len=64, device="cpu")],
        prompts)
    _same(r_done, t_done)
    assert all(r.status == "ok" for r in t_done.values())


def test_sampled_tokens_equal_the_reference_engine(gemma):
    """Every other request at temperature 0.8: the same seeded host RNG
    draws the same tokens from the same float32 logits."""
    rcfg, rparams, tcfg, tparams = gemma
    rng = np.random.default_rng(5)
    prompts = [(rng.integers(0, rcfg.vocab, 8).astype(np.int32),
                {"temperature": 0.8 if i % 2 else 0.0}) for i in range(4)]
    r_done, t_done = _serve(
        [REngine(rparams, rcfg, slots=2, max_len=64, seed=3),
         ServeEngine(tparams, tcfg, slots=2, max_len=64, seed=3,
                     device="cpu")],
        prompts, max_new_tokens=5)
    _same(r_done, t_done)


def test_deadline_eviction_matches_the_reference(gemma):
    rcfg, rparams, tcfg, tparams = gemma
    prompt = np.random.default_rng(0).integers(0, rcfg.vocab, 8) \
        .astype(np.int32)
    engines = [REngine(rparams, rcfg, slots=2, max_len=64),
               ServeEngine(tparams, tcfg, slots=2, max_len=64, device="cpu")]
    r_done, t_done = _serve(
        engines, [(prompt, {"max_new_tokens": 40, "deadline_steps": 3}),
                  (prompt, {"max_new_tokens": 4})])
    _same(r_done, t_done)
    assert t_done[0].status == "timed_out" and len(t_done[0].output) < 40
    assert engines[1].stats == engines[0].stats
    assert engines[1].stats["timed_out"] == 1


def test_injected_failures_give_the_reference_statuses_and_stats(gemma):
    rcfg, rparams, tcfg, tparams = gemma
    rng = np.random.default_rng(1)
    prompts = [(rng.integers(0, rcfg.vocab, 8).astype(np.int32), {})
               for _ in range(3)]
    engines = [
        REngine(rparams, rcfg, slots=2, max_len=64,
                fault_injector=r_faults.FaultInjector(
                    [r_faults.fail_request(rid=1, times=0),
                     r_faults.FaultSpec("decode", at=1)]),
                recovery=r_faults.RecoveryPolicy(max_attempts=2)),
        ServeEngine(tparams, tcfg, slots=2, max_len=64, device="cpu",
                    fault_injector=t_faults.FaultInjector(
                        [t_faults.fail_request(rid=1, times=0),
                         t_faults.FaultSpec("decode", at=1)]),
                    recovery=t_faults.RecoveryPolicy(max_attempts=2)),
    ]
    r_done, t_done = _serve(engines, prompts, max_new_tokens=4)
    _same(r_done, t_done)
    assert t_done[1].status == "error" and t_done[1].output == []
    assert engines[1].stats == engines[0].stats
    assert engines[1].stats["errors"] == 1
    assert engines[1].stats["retries"] == 2 + 1


@pytest.mark.parametrize("site", ["_prefill", "_decode"])
def test_a_real_failure_propagates_unretried(gemma, site):
    """Only injected failures are retried and absorbed; any other exception
    (a kernel's CUDA error on the card) reaches the caller at once, where
    the reference would retry it and mark the request ``error``."""
    _, _, cfg, params = gemma
    engine = ServeEngine(params, cfg, slots=2, max_len=32, device="cpu")
    calls = []

    def broken(*args):
        calls.append(args)
        raise ValueError("kernel failed")

    setattr(engine, site, broken)
    engine.submit(Request(rid=0, prompt=np.arange(6, dtype=np.int32),
                          max_new_tokens=3))
    with pytest.raises(ValueError, match="kernel failed"):
        engine.run()
    assert len(calls) == 1
    assert engine.stats["retries"] == 0 and engine.stats["errors"] == 0


def test_a_decode_batch_that_keeps_failing_raises_like_the_reference(gemma):
    """Injected decode failures past the retry budget leave the batch loop
    with the injected error, after the same retries as the reference."""
    rcfg, rparams, tcfg, tparams = gemma
    prompt = np.arange(6, dtype=np.int32)
    engines = [
        REngine(rparams, rcfg, slots=1, max_len=32,
                fault_injector=r_faults.FaultInjector(
                    [r_faults.FaultSpec("decode", times=0)]),
                recovery=r_faults.RecoveryPolicy(max_attempts=1)),
        ServeEngine(tparams, tcfg, slots=1, max_len=32, device="cpu",
                    fault_injector=t_faults.FaultInjector(
                        [t_faults.FaultSpec("decode", times=0)]),
                    recovery=t_faults.RecoveryPolicy(max_attempts=1)),
    ]
    for eng, req_cls, err in zip(engines, (RRequest, Request),
                                 (RuntimeError, t_faults.InjectedError)):
        eng.submit(req_cls(rid=0, prompt=prompt, max_new_tokens=3))
        with pytest.raises(err, match="injected decode-batch failure"):
            eng.run()
    assert engines[1].stats == engines[0].stats
    assert engines[1].stats["retries"] == 1


def test_metrics_match_the_reference(gemma):
    rcfg, rparams, tcfg, tparams = gemma
    regs = [RRegistry(), TRegistry()]
    clocks = [iter(range(1000)), iter(range(1000))]
    engines = [
        REngine(rparams, rcfg, slots=2, max_len=64, registry=regs[0],
                clock=lambda: float(next(clocks[0]))),
        ServeEngine(tparams, tcfg, slots=2, max_len=64, device="cpu",
                    registry=regs[1], clock=lambda: float(next(clocks[1]))),
    ]
    rng = np.random.default_rng(0)
    prompts = [(rng.integers(0, rcfg.vocab, 8).astype(np.int32), {})
               for _ in range(3)]
    _serve(engines, prompts, max_new_tokens=4)
    snap = regs[1].snapshot()
    assert snap == regs[0].snapshot()
    assert snap["serve.requests{status=completed}"] == 3
    assert snap["serve.decode_step_s.count"] == engines[1].stats["steps"]


def test_one_slot_engine_keeps_the_prefill_cache(gemma):
    """With one slot the batch-1 prefill state has no axis to splice along;
    the port copies it whole, so the engine's greedy tokens equal a
    prefill followed by decode steps.  The reference keeps the old state
    there and decodes from an empty cache (ROADMAP Queue C)."""
    rcfg, rparams, cfg, params = gemma
    prompt = np.random.default_rng(2).integers(0, cfg.vocab, 9) \
        .astype(np.int32)
    ref = REngine(rparams, rcfg, slots=1, max_len=32)
    ref.submit(RRequest(rid=0, prompt=prompt, max_new_tokens=4))
    ref.run()
    assert np.asarray(ref.state["pos"]).tolist() == [3]  # prompt dropped
    engine = ServeEngine(params, cfg, slots=1, max_len=32, device="cpu")
    engine.submit(Request(rid=0, prompt=prompt, max_new_tokens=4))
    got = engine.run()[0].output
    assert engine.state["pos"].tolist() == [9 + 3]
    state = t_api.init_decode_state(cfg, 1, 32, "cpu")
    logits, state = t_api.prefill(params, {"tokens": torch.from_numpy(
        prompt[None])}, cfg, state)
    want = [int(logits[0, -1].argmax())]
    for _ in range(3):
        logits, state = t_api.decode_step(
            params, torch.tensor([[want[-1]]], dtype=torch.int32), cfg, state)
        want.append(int(logits[0, -1].argmax()))
    assert got == want


def test_splice_writes_the_slot_in_place():
    cfg = config_from_reference(r_smoke("phi3-mini-3.8b"))
    state = t_api.init_decode_state(cfg, 3, 8, "cpu")
    single = t_api.init_decode_state(cfg, 1, 8, "cpu")
    single["k"].fill_(1.0)
    single["pos"].fill_(5)
    k_before = state["k"]
    out = _splice_state(state, single, 1)
    assert out["k"] is k_before
    assert state["pos"].tolist() == [0, 5, 0]
    assert float(state["k"][:, 1].min()) == 1.0
    assert float(state["k"][:, 0].abs().max()) == 0.0


def test_run_serving_on_the_cpu_returns_the_reference_keys():
    kw = dict(smoke=True, requests=3, prompt_len=8, max_new=4, slots=2)
    want = r_run_serving("gemma-2b", **kw)
    got = run_serving("gemma-2b", device="cpu", **kw)
    assert sorted(got) == sorted(want)
    for key in ("arch", "completed", "decode_tokens", "prefill_tokens"):
        assert got[key] == want[key], key
    assert got["tokens_per_s"] > 0


@pytest.mark.parametrize("arch,slots", [("rwkv6-3b", 2),
                                        ("recurrentgemma-2b", 3)])
def test_recurrent_families_serve_like_the_reference_engine(arch, slots):
    """Greedy tokens, statuses and ``stats`` equal the reference engine's;
    five requests on fewer slots reuse a slot, and the hybrid's prompts
    (up to 19 tokens, plus decode steps) run past its window of 16."""
    rcfg, rparams, tcfg, tparams = _both(arch, 0)
    rng = np.random.default_rng(7)
    prompts = [(rng.integers(0, rcfg.vocab, 9 + 2 * i).astype(np.int32),
                {"max_new_tokens": 3 + i}) for i in range(5)]
    engines = [REngine(rparams, rcfg, slots=slots, max_len=64),
               ServeEngine(tparams, tcfg, slots=slots, max_len=64,
                           device="cpu")]
    r_done, t_done = _serve(engines, prompts)
    _same(r_done, t_done)
    assert all(r.status == "ok" for r in t_done.values())
    assert engines[1].stats == engines[0].stats
    assert engines[1].stats["steps"] > 0


@pytest.mark.parametrize("arch,slots", [("granite-moe-1b-a400m", 2),
                                        ("granite-moe-3b-a800m", 3),
                                        ("whisper-medium", 1),
                                        ("whisper-medium", 3)])
def test_moe_and_whisper_serve_like_the_reference_engine(arch, slots):
    """Greedy tokens, statuses and ``stats`` equal the reference engine's
    for the MoE and encoder-decoder families; whisper's prefills get zero
    frames from both engines, and on several slots its cross-attention
    caches are spliced into the slot of each refill.  On one slot the
    port keeps the prefill's cache (ROADMAP Queue C), so there the port's
    tokens equal a prefill followed by decode steps."""
    rcfg, rparams, tcfg, tparams = _both(arch, 0)
    rng = np.random.default_rng(9)
    prompts = [(rng.integers(0, rcfg.vocab, 7 + 2 * i).astype(np.int32),
                {"max_new_tokens": 3 + i}) for i in range(5)]
    engines = [REngine(rparams, rcfg, slots=slots, max_len=48),
               ServeEngine(tparams, tcfg, slots=slots, max_len=48,
                           device="cpu")]
    r_done, t_done = _serve(engines, prompts)
    assert all(r.status == "ok" for r in t_done.values())
    assert engines[1].stats == engines[0].stats
    if slots > 1:
        _same(r_done, t_done)
        return
    frames = torch.zeros((1, tcfg.enc_frames, tcfg.d_model))
    for rid, (p, kw) in enumerate(prompts):
        state = t_api.init_decode_state(tcfg, 1, 48, "cpu")
        logits, state = t_api.prefill(tparams, {
            "tokens": torch.from_numpy(p[None]), "frames": frames}, tcfg,
            state)
        want = [int(logits[0, -1].argmax())]
        for _ in range(kw["max_new_tokens"] - 1):
            logits, state = t_api.decode_step(
                tparams, torch.tensor([[want[-1]]], dtype=torch.int32), tcfg,
                state)
            want.append(int(logits[0, -1].argmax()))
        assert t_done[rid].output == want, rid


def test_splice_writes_the_cross_attention_caches_like_the_reference():
    """A whisper prefill's four caches and ``pos``, spliced into slot 2 of
    three, give the reference's ``_splice_state`` leaf for leaf, written in
    place along the batch axis behind the layer axis."""
    rcfg, rparams, tcfg, tparams = _both("whisper-medium", 0)
    rng = np.random.default_rng(10)
    toks = rng.integers(0, rcfg.vocab, (1, 6)).astype(np.int32)
    frames = rng.standard_normal((1, rcfg.enc_frames, rcfg.d_model)) \
        .astype(np.float32)
    r_one = r_api.prefill(rparams, {"tokens": jax.numpy.asarray(toks),
                                    "frames": jax.numpy.asarray(frames)},
                          rcfg, r_api.init_decode_state(rcfg, 1, 16))[1]
    t_one = t_api.prefill(tparams, {"tokens": torch.from_numpy(toks),
                                    "frames": torch.from_numpy(frames)},
                          tcfg, t_api.init_decode_state(tcfg, 1, 16, "cpu"))[1]
    want = r_splice_state(r_api.init_decode_state(rcfg, 3, 16), r_one, 2)
    state = t_api.init_decode_state(tcfg, 3, 16, "cpu")
    cross_k = state["cross_k"]
    got = _splice_state(state, t_one, 2)
    assert got["cross_k"] is cross_k
    assert float(cross_k[:, 2].abs().max()) > 0
    assert float(cross_k[:, :2].abs().max()) == 0
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].float().numpy(),
                                   np.asarray(w, np.float32), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "whisper-medium"])
def test_run_serving_serves_the_moe_and_whisper_families(arch):
    kw = dict(smoke=True, requests=3, prompt_len=8, max_new=4, slots=2)
    want = r_run_serving(arch, **kw)
    got = run_serving(arch, device="cpu", **kw)
    for key in ("arch", "completed", "decode_tokens", "prefill_tokens"):
        assert got[key] == want[key], key


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "whisper-medium"])
def test_serve_driver_and_example_run_the_family_on_the_cpu(arch, capsys):
    """``python -m repro_torch.launch.serve --smoke --device cpu`` and the
    ``serve_lm`` example, end to end."""
    import json

    from repro_torch.examples import serve_lm
    from repro_torch.launch import serve

    serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--requests",
                "3", "--prompt-len", "6", "--max-new", "3", "--slots", "2"])
    out = json.loads(capsys.readouterr().out)
    assert out["completed"] == 3 and out["decode_tokens"] == 3 * 2
    serve_lm.main(["--arch", arch, "--device", "cpu", "--requests", "3"])
    assert "3/3 requests" in capsys.readouterr().out


def _flat(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def test_splice_walks_the_hybrid_state_like_the_reference():
    """The hybrid's state nests dicts (``rec1``, ``rec2``) and a list of
    dicts (``tail``): a batch-1 prefill spliced into slot 1 of three gives
    the reference's ``_splice_state``, leaf for leaf, written in place."""
    rcfg, rparams, tcfg, tparams = _both("recurrentgemma-2b", 0)
    toks = np.random.default_rng(8).integers(0, rcfg.vocab, (1, 20)) \
        .astype(np.int32)
    r_one = r_api.prefill(rparams, {"tokens": jax.numpy.asarray(toks)}, rcfg,
                          r_api.init_decode_state(rcfg, 1, 32))[1]
    t_one = t_api.prefill(tparams, {"tokens": torch.from_numpy(toks)}, tcfg,
                          t_api.init_decode_state(tcfg, 1, 32, "cpu"))[1]
    want = r_splice_state(r_api.init_decode_state(rcfg, 3, 32), r_one, 1)
    state = t_api.init_decode_state(tcfg, 3, 32, "cpu")
    tail_h = state["tail"][0]["h"]
    got = _splice_state(state, t_one, 1)
    assert got is state and got["tail"][0]["h"] is tail_h
    assert float(tail_h[1].abs().max()) > 0 and float(tail_h[0].abs().max()) == 0
    w_leaves, g_leaves = _flat(want), jax.tree.leaves(got)
    assert len(g_leaves) == len(w_leaves) == 12
    for (path, w), g in zip(w_leaves, g_leaves):
        assert tuple(g.shape) == w.shape, jax.tree_util.keystr(path)
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32),
                                   rtol=1e-4, atol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))

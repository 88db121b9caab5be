"""The port's checkpoint manager and the supervised training driver, on the
CPU: the reference's checkpoint and fault tests on the port, a bf16 state
stored as raw bits and restored bit for bit, the fall-back past a corrupt
newest step, and ``run_training``'s supervisor events against the
reference's for the same fault schedule."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_smoke_config
from repro_torch.core.faults import FaultInjector, fail_step
from repro_torch.data import DataConfig, TokenStream
from repro_torch.dist.fault import TrainSupervisor
from repro_torch.launch.train import run_training
from repro_torch.train.train_loop import init_train_state, make_train_step


def _state(arch="gemma-2b", **kw):
    cfg = dataclasses.replace(get_smoke_config(arch), attention_impl="xla",
                              **kw)
    return cfg, init_train_state(torch.Generator().manual_seed(0), cfg,
                                 "cpu")


def _tensors(state):
    return list(state.params.parameters()) + [state.opt.step] + [
        t for tree in (state.opt.master, state.opt.mu, state.opt.nu)
        for t in tree.values()]


def _assert_equal(a, b):
    ta, tb = _tensors(a), _tensors(b)
    assert len(ta) == len(tb)
    for x, y in zip(ta, tb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.detach(), y.detach())


def test_roundtrip(tmp_path):
    _, state = _state("stablelm-3b")
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(7, state, blocking=True)
    restored, meta = mgr.restore(state)
    assert meta["step"] == 7
    _assert_equal(restored, state)
    # new tensors, a new module, gradients on as in the template
    assert restored.params is not state.params
    assert all(p.requires_grad for p in restored.params.parameters())
    assert restored.params.embed.data_ptr() != state.params.embed.data_ptr()
    with open(tmp_path / "step_00000007" / "manifest.json") as f:
        manifest = json.load(f)
    assert "params/embed" in manifest["keys"]
    assert "opt/master/layers.0.wq" in manifest["keys"]
    assert manifest["dtypes"]["opt/step"] == "int32"


def test_bf16_state_roundtrips_bit_for_bit(tmp_path):
    _, state = _state(dtype="bfloat16")
    assert state.params.embed.dtype == torch.bfloat16
    step = make_train_step(_state(dtype="bfloat16")[0],
                           lr_schedule=lambda s: 1e-3)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (2, 8)).astype(np.int32))
    state, _ = step(state, {"tokens": toks})
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state, blocking=True)
    raw = np.load(tmp_path / "step_00000001" / "params__embed.npy")
    assert raw.dtype == np.int16
    restored, _ = mgr.restore(state)
    _assert_equal(restored, state)
    # the bits, not only the values (a NaN payload or -0 would survive too)
    assert torch.equal(restored.params.embed.detach().view(torch.int16),
                       state.params.embed.detach().view(torch.int16))


def test_restore_puts_leaves_on_the_template_device_and_dtype(tmp_path):
    _, state = _state()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, state, blocking=True)
    template = dataclasses.replace(state)
    template.opt = dataclasses.replace(
        state.opt, master={k: v.double() for k, v in state.opt.master.items()})
    restored, _ = mgr.restore(template)
    assert all(v.dtype == torch.float64
               for v in restored.opt.master.values())
    seen = []
    mgr.restore(state, put=lambda key, host: seen.append(key) or host)
    assert "opt/nu/embed" in seen


def test_save_snapshots_before_later_in_place_updates(tmp_path):
    """The train step updates the state in place; a save in flight must
    hold the state as it was when ``save`` was called."""
    _, state = _state()
    mgr = CheckpointManager(str(tmp_path))
    want = state.opt.master["embed"].clone()
    mgr.save(1, state)
    state.opt.master["embed"].add_(1.0)
    mgr.wait()
    restored, _ = mgr.restore(state)
    assert torch.equal(restored.opt.master["embed"], want)


def test_retention(tmp_path):
    _, state = _state()
    mgr = CheckpointManager(str(tmp_path), keep=2)
    os.makedirs(tmp_path / "tmp-step_00000009")  # a stale in-flight write
    for s in (1, 2, 3, 4):
        mgr.save(s, state, blocking=True)
    assert mgr.available_steps() == [3, 4]
    assert not (tmp_path / "tmp-step_00000009").exists()


def test_corrupt_newest_step_falls_back_to_the_previous_one(tmp_path):
    cfg, state = _state()
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, state, blocking=True)
    step = make_train_step(cfg, lr_schedule=lambda s: 1e-3)
    toks = torch.zeros((2, 8), dtype=torch.int32)
    state, _ = step(state, {"tokens": toks})
    mgr.save(2, state, blocking=True)
    good2, _ = mgr.restore(state, step=2)
    # a truncated leaf: the manifest checks pass, the load fails
    leaf = tmp_path / "step_00000002" / "params__embed.npy"
    leaf.write_bytes(leaf.read_bytes()[:40])
    restored, meta = mgr.restore(state)
    assert meta["step"] == 1 and [s for s, _ in mgr.skipped] == [2]
    with pytest.raises(Exception):
        mgr.restore(state, step=2)
    # a missing leaf: the manifest check itself skips the step
    leaf.unlink()
    assert mgr.latest_step() == 1
    # a torn manifest likewise
    mgr.save(3, good2, blocking=True)
    (tmp_path / "step_00000003" / "manifest.json").write_text("{")
    assert mgr.latest_step() == 1
    assert int(mgr.restore(state)[0].step) == 0


def test_resume_bit_exact(tmp_path):
    """Train 10 steps; against train 5, checkpoint, restore, train 5 more:
    identical state (deterministic data and optimizer)."""
    cfg, _ = _state()
    stream = TokenStream(DataConfig(vocab=cfg.vocab, seq_len=32,
                                    global_batch=4))
    step_fn = make_train_step(cfg, donate=False)

    def train(state, lo, hi):
        for s in range(lo, hi):
            b = {"tokens": torch.from_numpy(stream.batch_at(s)["tokens"])}
            state, _ = step_fn(state, b)
        return state

    a = train(_state()[1], 0, 10)
    b = train(_state()[1], 0, 5)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, b, blocking=True)
    b2, meta = mgr.restore(_state()[1])
    b3 = train(b2, meta["step"], 10)
    _assert_equal(a, b3)


def test_supervisor_restart_from_checkpoint_matches_the_reference(
        tmp_path, monkeypatch):
    """A failure at step 10 with a checkpoint every 4 steps, on both sides.

    The port saves asynchronously and restores exactly the step its
    supervisor's ``resume`` event names, so that event and the step
    training resumes from agree whichever checkpoint was durable (8, or 4
    while 8 is still being written).  The reference keeps the race: its
    ``run_from`` reads ``latest_step()`` a second time and can train from
    8 while the event says 4.  Its saves are made blocking here (through
    ``monkeypatch``), so that its two reads cannot disagree: it resumes
    from 8."""
    import repro.ckpt.checkpoint as r_ckpt
    from repro.launch.train import run_training as r_run_training

    kw = dict(smoke=True, steps=16, batch=2, seq=32, ckpt_every=4,
              fail_at_step=10)
    res = run_training("gemma-2b", ckpt_dir=str(tmp_path / "port"),
                       device="cpu", **kw)
    # failure injected at step 10: restart from checkpoint 8, finish at 16
    kinds = [e["kind"] for e in res["events"]]
    assert "failure" in kinds and "resume" in kinds
    assert res["steps"] >= 16 and res["attention_impl"] == "xla"
    save = r_ckpt.CheckpointManager.save
    monkeypatch.setattr(
        r_ckpt.CheckpointManager, "save",
        lambda self, step, state, metadata=None, blocking=False:
        save(self, step, state, metadata, blocking=True))
    ref = r_run_training("gemma-2b", ckpt_dir=str(tmp_path / "ref"), **kw)
    assert kinds == [e["kind"] for e in ref["events"]]
    # the port's saves are asynchronous: the resume lands on the last
    # durable checkpoint, 8 or one interval earlier
    resume = [e["step"] for e in res["events"] if e["kind"] == "resume"]
    assert resume in ([8], [4])
    # ten steps to the failure, then from the resume to the end
    assert len(res["losses"]) == 10 + 16 - resume[0]
    # the step the port resumed from, as its loss count shows it, is the
    # one its resume event names
    assert 10 + 16 - len(res["losses"]) == resume[0]
    ref_resume = [e["step"] for e in ref["events"] if e["kind"] == "resume"]
    assert ref_resume == [8]
    assert len(ref["losses"]) == 10 + 16 - 8


def test_restart_restores_the_step_the_supervisor_recorded(tmp_path,
                                                           monkeypatch):
    """The race of the asynchronous save, made certain: a checkpoint
    manager whose ``latest_step()`` answers 4 to the supervisor's two reads
    (the failure and the resume events) although step 8 is on disk, and 8
    afterwards.  The port restores step 4, the one its ``resume`` event
    names, and logs 10 + 16 - 4 losses; a second read of ``latest_step()``
    would have restored 8."""
    import repro_torch.launch.train as launch_train

    class Racing(CheckpointManager):
        held = 2  # the supervisor's reads that see 4

        def save(self, step, state, metadata=None, blocking=False,
                 specs=None):
            super().save(step, state, metadata, blocking=True, specs=specs)

        def latest_step(self):
            step = super().latest_step()
            if step == 8 and self.held:
                self.held -= 1
                return 4
            return step

    monkeypatch.setattr(launch_train, "CheckpointManager", Racing)
    res = run_training("gemma-2b", smoke=True, steps=16, batch=2, seq=32,
                       ckpt_dir=str(tmp_path), ckpt_every=4, fail_at_step=10,
                       device="cpu")
    events = [(e["kind"], e["step"]) for e in res["events"]]
    assert events == [("failure", 4), ("resume", 4), ("complete", 16)]
    assert len(res["losses"]) == 10 + 16 - 4


def test_fault_injector_schedule_through_run_training(tmp_path):
    res = run_training(
        "gemma-2b", smoke=True, steps=16, batch=2, seq=32,
        ckpt_dir=str(tmp_path), ckpt_every=4,
        fault_injector=FaultInjector([fail_step(at=10)]),
        supervisor_backoff=0.01, jitter_seed=3, sleep=lambda d: None,
        device="cpu")
    assert [e["kind"] for e in res["events"]] == ["failure", "resume",
                                                  "complete"]


def test_supervisor_gives_up_after_max_restarts(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    sup = TrainSupervisor(mgr, max_restarts=2)

    def always_fail(start):
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError):
        sup.run(always_fail, total_steps=10)
    assert len([e for e in sup.events if e.kind == "failure"]) == 3


@pytest.mark.parametrize("arch", ["internvl2-26b", "whisper-medium"])
def test_run_training_feeds_the_reference_extra_inputs(arch):
    """The VLM's patch embeddings and Whisper's frames, from numpy at
    ``seed + step`` as the reference makes them, reach the train step."""
    res = run_training(arch, smoke=True, steps=6, batch=2, seq=16,
                       log_every=100, device="cpu")
    assert res["steps"] == 6 and len(res["losses"]) == 6
    assert all(np.isfinite(res["losses"]))


def test_run_training_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_training("gemma-2b", steps=1, batch=2, seq=8)

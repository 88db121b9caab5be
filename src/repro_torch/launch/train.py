"""End-to-end training driver.

config -> data pipeline -> train step -> checkpoint manager -> supervisor
loop with heartbeat and straggler monitoring, on one device:

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch gemma-2b --steps 10 --batch 8 --seq 512

trains the full architecture on the GPU; ``--smoke`` selects the reduced
config, and ``--device cpu`` is the only way to run on the CPU.
``--mesh 2,2`` trains over 4 ranks on a ``("data", "model")`` mesh of (2,
2) under ``rules_for`` "tp" (the batch split over ``"data"``, the ZeRO-1
optimizer state over it, every family's layers tensor-parallel over
``"model"``; checkpoints saved sharded and restored by
``restore_resharded``): one card a rank where there are as many (NCCL),
else every rank on the first card under gloo; with ``--device cpu`` the
ranks are on the CPU (gloo).

The step trains through the models' plain attention and scans
(``attention_impl="xla"``), the reference's default and the path the
reference trains through: the hand-written CUDA kernels, like the
reference's Pallas kernels, are forward-only.  The result says so
(``"attention_impl": "xla"``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch.ckpt import CheckpointManager, restore_resharded
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.core.faults import FaultInjector
from repro_torch.data.pipeline import DataConfig, TokenStream
from repro_torch.device import resolve_device
from repro_torch.dist import ranks
from repro_torch.dist.fault import (
    HeartbeatMonitor,
    StragglerMonitor,
    TrainSupervisor,
)
from repro_torch.models.config import ModelConfig
from repro_torch.obs.metrics import MetricsRegistry, default_registry
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.launch.mesh import parse_mesh, spawn_backend
from repro_torch.train.train_loop import (
    init_train_state,
    make_train_step,
    train_state_specs,
)


def run_training(
    arch: str,
    *,
    smoke: bool = True,
    steps: int = 50,
    batch: int = 8,
    seq: int = 128,
    microbatches: int = 1,
    ckpt_dir: str | None = None,
    ckpt_every: int = 20,
    seed: int = 0,
    log_every: int = 10,
    fail_at_step: int | None = None,  # legacy one-shot fault injection
    fault_injector: FaultInjector | None = None,  # general fault schedule
    supervisor_backoff: float = 0.0,
    jitter_seed: int | None = None,  # decorrelated restart jitter
    clock=time.monotonic,
    sleep=time.sleep,
    registry: MetricsRegistry | None = None,
    tracer=None,
    device: torch.device | str | None = None,
    cfg: ModelConfig | None = None,
    mesh: tuple[int, int] | None = None,
    rules=None,
) -> dict:
    """Train ``arch`` (its smoke config with ``smoke``; ``cfg``, where
    given, in place of both) on ``device`` (None: the GPU) from random
    parameters made from ``seed``, on the token stream from ``seed``.
    With ``mesh`` (data, model), over that many ranks
    (``launch.mesh.spawn_backend``), each running this with ``rules``
    (``rules_for`` "tp" on its ``DeviceMesh``): rank 0's result, the ranks'
    losses required equal."""
    if mesh is not None:
        world = mesh[0] * mesh[1]
        backend, where = spawn_backend(device, world)
        kw = dict(smoke=smoke, steps=steps, batch=batch, seq=seq,
                  microbatches=microbatches, ckpt_dir=ckpt_dir,
                  ckpt_every=ckpt_every, seed=seed, log_every=log_every,
                  fail_at_step=fail_at_step, fault_injector=fault_injector,
                  supervisor_backoff=supervisor_backoff,
                  jitter_seed=jitter_seed, cfg=cfg)
        out = ranks.spawn(_train_rank, world, backend=backend, device=where,
                          args=(arch, kw, tuple(mesh)))
        if any(o["losses"] != out[0]["losses"] for o in out):
            raise RuntimeError("the ranks' losses differ")
        return {**out[0], "mesh": list(mesh), "backend": backend or "nccl"}
    device = resolve_device(device)
    reg = registry if registry is not None else default_registry()
    tracer = tracer or NULL_TRACER
    if cfg is None:
        cfg = get_smoke_config(arch) if smoke else get_config(arch)
    cfg = dataclasses.replace(cfg, attention_impl="xla")
    data = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch,
                      seed=seed)
    stream = TokenStream(data)
    step_fn = make_train_step(cfg, rules, None if rules is None
                              else rules.mesh, microbatches=microbatches)
    specs = None if rules is None else train_state_specs(cfg, rules)
    ckpt = CheckpointManager(ckpt_dir, keep=2) if ckpt_dir else None
    log = rules is None or ranks.axis_index(
        tuple(rules.mesh.mesh_dim_names)) == 0

    def restore(state, step=None):
        if specs is None:
            return ckpt.restore(state, step=step)
        return restore_resharded(ckpt, state, specs, rules.mesh, step=step)
    monitor = HeartbeatMonitor(num_hosts=1)
    stragglers = StragglerMonitor(monitor)
    losses: list[float] = []

    def extra(step: int, n: int) -> torch.Tensor:
        """The encoder frames or patch embeddings of ``step``: numpy from
        ``seed + step``, as the reference makes them."""
        rng = np.random.default_rng(seed + step)
        x = rng.standard_normal((batch, n, cfg.d_model), np.float32)
        return torch.from_numpy(x).to(device=device, dtype=cfg.torch_dtype)

    def make_batch(step: int) -> dict:
        b = stream.batch_at(step)
        out = {"tokens": torch.from_numpy(b["tokens"]).to(device)}
        if cfg.family == "encdec":
            out["frames"] = extra(step, cfg.enc_frames)
        if cfg.family == "vlm":
            out["patch_embeds"] = extra(step, cfg.n_patches)
        return out

    armed = {"fail": fail_at_step is not None}
    entered = {"first": True}

    def run_from(start: int) -> int:
        """Train from ``start``.  The first entry resumes from the newest
        checkpoint, if any (a rerun of an earlier run); a restart restores
        exactly the step the supervisor recorded in its ``resume`` event:
        a second read of ``latest_step()`` could see an asynchronous save
        published since, and train from another step than the event
        says."""
        gen = torch.Generator(device=device).manual_seed(seed)
        state = init_train_state(gen, cfg, device, rules)
        first, entered["first"] = entered["first"], False
        if ckpt is not None and start > 0:
            state, meta = restore(state, step=start)
        elif ckpt is not None and first and ckpt.latest_step() is not None:
            state, meta = restore(state)
            start = meta["step"]
        step = start
        while step < steps:
            t0 = clock()
            batch_data = make_batch(step)
            state, metrics = step_fn(state, batch_data)
            loss = float(metrics["loss"])
            losses.append(loss)
            step += 1
            dt = clock() - t0
            reg.counter("train.steps").inc()
            reg.histogram("train.step_s").observe(dt)
            if dt > 0:
                reg.gauge("train.tokens_per_s").set(batch * seq / dt)
            if tracer.enabled:
                # t0/dt come from the injected ``clock`` so the trace is
                # self-consistent (and deterministic when tests fake it).
                tracer.complete("train.step", t0, dt, stream="train",
                                cat="compute",
                                args={"step": step, "loss": loss})
            monitor.beat(0, dt)
            stragglers.evaluate()
            if armed["fail"] and step == fail_at_step:
                armed["fail"] = False  # one-shot fault injection
                raise RuntimeError(f"injected worker failure at {step}")
            if fault_injector is not None and fault_injector.probe(
                "step", task=step, site="train_step"
            ):
                raise RuntimeError(f"injected step failure at {step}")
            if ckpt is not None and step % ckpt_every == 0:
                ckpt.save(step, state, specs=specs)
            if step % log_every == 0 and log:
                print(f"step {step:5d} loss {loss:.4f} "
                      f"({clock() - t0:.2f}s/step)")
        if ckpt is not None:
            ckpt.save(steps, state, blocking=True, specs=specs)
        return step

    if ckpt is not None:
        sup = TrainSupervisor(ckpt, backoff=supervisor_backoff,
                              sleep=sleep, clock=clock,
                              jitter_seed=jitter_seed)
        last = sup.run(run_from, steps)
        events = [dataclass_event(e) for e in sup.events]
    else:
        last = run_from(0)
        events = []
    if ckpt is not None:
        ckpt.wait()
    return {
        "arch": cfg.name,
        "steps": last,
        "first_loss": losses[0] if losses else None,
        "last_loss": losses[-1] if losses else None,
        "losses": losses,
        "events": events,
        "attention_impl": cfg.attention_impl,
        "device": str(device),
    }


def _train_rank(device, arch: str, kw: dict, mesh_shape: tuple) -> dict:
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.rules import rules_for

    mesh = make_mesh(mesh_shape, ("data", "model"))
    cfg = kw.pop("cfg") or (get_smoke_config(arch) if kw["smoke"]
                            else get_config(arch))
    rules = rules_for(cfg, mesh, "tp", global_batch=kw["batch"])
    return run_training(arch, device=device, cfg=cfg, rules=rules, **kw)


def dataclass_event(e) -> dict:
    return {"kind": e.kind, "step": e.step, "detail": e.detail}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' to run on "
                         "the CPU)")
    ap.add_argument("--mesh", default=None,
                    help="DATA,MODEL: train over that many ranks on a "
                         "('data', 'model') mesh (such as 2,2)")
    args = ap.parse_args(argv)
    result = run_training(
        args.arch, smoke=args.smoke, steps=args.steps, batch=args.batch,
        seq=args.seq, microbatches=args.microbatches,
        ckpt_dir=args.ckpt_dir, seed=args.seed, device=args.device,
        mesh=parse_mesh(args.mesh),
    )
    print(json.dumps({k: v for k, v in result.items() if k != "losses"},
                     indent=2))


if __name__ == "__main__":
    main()

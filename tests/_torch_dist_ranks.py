"""Rank bodies for ``tests/test_torch_dist*.py``.

``repro_torch.dist.ranks.spawn`` starts each rank in a new process, which
imports the function it runs by module; these live here, apart from the
test modules, so that a rank imports only torch and the port (never JAX or
the reference).  Each takes the rank's device first and returns plain
numpy arrays and numbers.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.ckpt import CheckpointManager, restore_resharded
from repro_torch.dist import (
    hierarchical_grad_allreduce,
    ranks,
    ring_allgather_matmul,
    ring_allreduce,
    set_tracer,
)
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.rules import rules_for
from repro_torch.models.attention import combine_decode_partials
from repro_torch.obs.trace import Tracer
from repro_torch.optim import compressed_psum
from repro_torch.optim import AdamWState
from repro_torch.train.train_loop import (
    TrainState,
    local_train_state,
    make_train_step,
    train_state_specs,
)


@contextlib.contextmanager
def beside(fn, *args, **kw):
    """Run ``fn(*args, **kw)`` in a thread while the block runs (the
    reference's subprocess beside the port's ranks); its return value is
    ``["result"]`` of the yielded dict after the block, and its exception
    is raised there."""
    out: dict = {}

    def run():
        try:
            out["result"] = fn(*args, **kw)
        except BaseException as e:  # noqa: BLE001 - raised after the join
            out["error"] = e

    thread = threading.Thread(target=run)
    thread.start()
    try:
        yield out
    finally:
        thread.join()
    if "error" in out:
        raise out["error"]


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().to("cpu", torch.float32).numpy()


def collectives(device, inputs: dict) -> dict:
    """Every collective of the port on this rank's part of ``inputs``: a
    ring of 4 along ``"data"`` (mesh (4,)) and a (2, 2) ``("pod", "data")``
    mesh for the hierarchical all-reduce; the spans of a tracer."""
    ring = make_mesh((4,), ("data",))
    r = dist.get_rank()
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa
    tracer = Tracer()
    prev = set_tracer(tracer)
    out = {"rank": r, "index": ranks.axis_index("data")}
    try:
        for key in ("two_phase", "rotate", "integers"):
            out[key] = _np(ring_allreduce(t(inputs[key][r]), "data"))
        k = inputs["x"].shape[1] // 4
        out["matmul"] = _np(ring_allgather_matmul(
            t(inputs["x"][:, r * k:(r + 1) * k]),
            t(inputs["w"][r * k:(r + 1) * k]), axis_name="data"))
        got, ef = compressed_psum({"g": t(inputs["g"][r])}, "data", None)
        out["compressed"] = _np(got["g"])
        out["no_feedback"] = ef is None
        pre = ranks.staged_bytes()
        res = combine_decode_partials(t(inputs["part_out"][r]),
                                      t(inputs["part_lse"][r]), "data")
        out["combined"] = _np(res)
        out["staged"] = ranks.staged_bytes() - pre
        out["gather"] = _np(ranks.all_gather(t(np.float32([r])), "data"))
        out["perm"] = _np(ranks.ppermute(t(np.float32([r])), "data",
                                         [(0, 2), (2, 0), (1, 3)]))
        hier_mesh = make_mesh((2, 2), ("pod", "data"))
        out["coords"] = (ranks.axis_index("pod"), ranks.axis_index("data"),
                         ranks.axis_index(("pod", "data")))
        grads = {"w": t(inputs["grads"][r]), "b": [t(inputs["grads"][r][0])]}
        hier = hierarchical_grad_allreduce(grads, ("data",), ("pod",))
        flat = ranks.psum(grads["w"], ("pod", "data"))
        out["hier"] = _np(hier["w"])
        out["hier_b"] = _np(hier["b"][0])
        out["flat"] = _np(flat)
        out["mesh_ranks"] = hier_mesh.mesh.tolist()
    finally:
        set_tracer(prev)
    out["events"] = [(e["name"], e["stream"], e["cat"], dict(e["args"]))
                     for e in tracer.events if e.get("ph") == "X"]
    return out


def whole_train_state(state, cfg, rules, mesh) -> TrainState:
    """The whole train state from every rank's part (an all-gather of each
    leaf the ZeRO-1 specs split); every rank calls it."""
    specs = train_state_specs(cfg, rules)
    with ranks.use_mesh(mesh):
        def whole(tree):
            return {k: ranks.spec_gather(v, specs.opt.master[k])
                    for k, v in tree.items()}
        opt = state.opt
        return TrainState(state.params, AdamWState(
            opt.step, whole(opt.master), whole(opt.mu), whole(opt.nu)))


def train_steps(device, cases: list, mesh_shape: tuple) -> list:
    """For each (label, cfg, flavor, state, batch) of ``cases``: one
    sharded train step from a copy of ``state`` on a
    ``("data", "model")`` mesh of ``mesh_shape``; the loss, the gradient
    norm, and the whole new master and moments (gathered), on rank 0."""
    import copy

    mesh = make_mesh(mesh_shape, ("data", "model"))
    out = []
    for label, cfg, flavor, state, batch in cases:
        rules = rules_for(cfg, mesh, flavor,
                          global_batch=batch["tokens"].shape[0])
        step = make_train_step(cfg, rules, mesh)
        new, metrics = step(copy.deepcopy(state), batch)
        local = {k: tuple(v.shape) for k, v in new.opt.master.items()}
        whole = whole_train_state(new, cfg, rules, mesh)
        params = {k: p.detach().clone()
                  for k, p in new.params.named_parameters()}
        res = {"label": label, "loss": float(metrics["loss"]),
               "grad_norm": float(metrics["grad_norm"]),
               "lr": float(metrics["lr"]), "step": int(new.step),
               "local_shapes": local, "params": params}
        if dist.get_rank() == 0:
            for tree in ("master", "mu", "nu"):
                res[tree] = {k: v.clone()
                             for k, v in getattr(whole.opt, tree).items()}
        out.append(res)
    return out


def save_sharded(device, cfg, state, directory: str, step: int) -> dict:
    """The ZeRO-1 state of a (4, 1) mesh, saved by every rank."""
    mesh = make_mesh((4, 1), ("data", "model"))
    rules = rules_for(cfg, mesh, "tp")
    local = local_train_state(state, cfg, rules, mesh)
    shapes = {k: tuple(v.shape) for k, v in local.opt.master.items()}
    CheckpointManager(directory).save(step, local,
                                      specs=train_state_specs(cfg, rules))
    return {"shapes": shapes,
            "files": sorted(os.listdir(directory))}


def restore_onto(device, cfg, template, directory: str,
                 mesh_shape: tuple) -> dict:
    """This rank's slices of a checkpoint under the ZeRO-1 specs of a
    ``("data", "model")`` mesh of ``mesh_shape``."""
    mesh = make_mesh(mesh_shape, ("data", "model"))
    rules = rules_for(cfg, mesh, "tp")
    specs = train_state_specs(cfg, rules)
    state, meta = restore_resharded(CheckpointManager(directory), template,
                                    specs, mesh)
    with ranks.use_mesh(mesh):
        index = ranks.axis_index("data")
    return {"index": index, "step": meta["step"],
            "params": {k: p.detach().clone()
                       for k, p in state.params.named_parameters()},
            "opt_step": int(state.opt.step),
            **{tree: dict(getattr(state.opt, tree))
               for tree in ("master", "mu", "nu")}}


def replace_impl(cfg, impl="xla"):
    return dataclasses.replace(cfg, attention_impl=impl)

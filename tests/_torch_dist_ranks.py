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


# ---------------------------------------------------------------------------
# Tensor parallelism over "model" (tests/test_torch_tp.py)
# ---------------------------------------------------------------------------


def whole_tp_state(state, cfg, rules, mesh) -> dict:
    """Every leaf of a tensor-parallel train state gathered whole (the
    params over ``"model"``, the optimizer's leaves over every axis their
    specs split); every rank calls it."""
    specs = train_state_specs(cfg, rules)
    with ranks.use_mesh(mesh):
        out = {"params": {k: ranks.spec_gather(p.detach(), specs.params[k])
                          for k, p in state.params.named_parameters()}}
        for tree in ("master", "mu", "nu"):
            out[tree] = {k: ranks.spec_gather(v, specs.opt.master[k])
                         for k, v in getattr(state.opt, tree).items()}
    return out


@contextlib.contextmanager
def recorded_collectives():
    """Every all-reduce and all-gather of ``ranks`` inside the block, as a
    recording mesh records them: ``(op, axis, operand bytes, output
    bytes)``, in the list it yields (the train step sends nothing by
    ``ppermute``)."""
    records = []
    reduce, gather = ranks._all_reduce, ranks._gather_one
    size = lambda x: x.numel() * x.element_size()  # noqa: E731

    def all_reduce(x, op, axis):
        out = reduce(x, op, axis)
        records.append(("all-reduce", axis, size(x), size(out)))
        return out

    def gather_one(x, axis):
        out = gather(x, axis)
        records.append(("all-gather", axis, size(x), size(out)))
        return out

    ranks._all_reduce, ranks._gather_one = all_reduce, gather_one
    try:
        yield records
    finally:
        ranks._all_reduce, ranks._gather_one = reduce, gather


def _tp_train(mesh, cases, microbatches: int = 1) -> list:
    import copy

    out = []
    for label, cfg, state, batch in cases:
        rules = rules_for(cfg, mesh, "tp",
                          global_batch=batch["tokens"].shape[0])
        step = make_train_step(cfg, rules, mesh, microbatches=microbatches)
        state = copy.deepcopy(state)
        with recorded_collectives() as records:
            new, metrics = step(state, batch)
        split = step_split(cfg, rules, mesh)
        with ranks.use_mesh(mesh):
            index = ranks.axis_index("model")
        res = {"label": label, "model_index": index,
               "loss": float(metrics["loss"]),
               "grad_norm": float(metrics["grad_norm"]),
               "lr": float(metrics["lr"]), "step": int(new.step),
               "local_shapes": {k: tuple(p.shape) for k, p in
                                new.params.named_parameters()},
               "collectives": records,
               "replicated": {k: p.detach().clone() for k, p in
                              new.params.named_parameters()
                              if k not in split},
               # the hybrid's w_in ([z | y]): this rank's part of each block
               "w_in": {k: p.detach().clone() for k, p in
                        new.params.named_parameters()
                        if k.endswith(".w_in")}}
        whole = whole_tp_state(new, cfg, rules, mesh)
        if dist.get_rank() == 0:
            res.update(whole)
        out.append(res)
    return out


def step_split(cfg, rules, mesh) -> set:
    """The names of the params that ``rules`` split over ranks."""
    specs = train_state_specs(cfg, rules).params
    with ranks.use_mesh(mesh):
        return {k for k, s in specs.items() if ranks.spec_shards(s)}


def _flat(tree, prefix="") -> dict:
    """The tensors of a nested state by path, dict keys sorted (the
    reference's ``jax.tree.leaves`` order)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
        return out
    return {prefix.rstrip("/"): tree}


def _tp_serve(mesh, cases, shard_seq: bool = False) -> list:
    """Prefill then decode steps teacher-forced on ``decode`` tokens, each
    rank on its rows of the batch (the data axis splits it), through the
    port's api with the reference's parameters carried onto the rank; each
    decode step from this rank's slice of a given cache where the case
    gives the caches; the final state gathered whole by ``state_specs``
    (where no cache is given); the collectives of the first decode step
    and its ``collective:*`` spans.  ``shard_seq``: the rules split the
    cache's sequence over ``"model"`` where its spec keeps the KV heads
    whole."""
    from repro_torch.convert import params_from_reference
    from repro_torch.models import api

    out = []
    for label, cfg, np_params, tokens, decode, extra, max_len, given \
            in cases:
        b = tokens.shape[0]
        rules = rules_for(cfg, mesh, "tp", global_batch=b,
                          shard_seq=shard_seq)
        params = params_from_reference(np_params, cfg, "cpu", rules)
        with ranks.use_mesh(mesh):
            data = ranks.axis_size("data")
            rows = slice(ranks.axis_index("data") * (b // data),
                         (ranks.axis_index("data") + 1) * (b // data))
        batch = {"tokens": torch.from_numpy(tokens[rows])}
        for key, name in (("patches", "patch_embeds"), ("frames", "frames")):
            if key in extra:
                batch[name] = torch.from_numpy(extra[key][rows])
        state = api.init_decode_state(cfg, b // data, max_len, "cpu", rules)
        logits, state = api.prefill(params, batch, cfg, state, rules)
        got = [logits.float().numpy()]
        specs = api.state_specs(cfg, rules)
        wrote = []
        records, spans = None, None
        for i, tok in enumerate(decode):
            if given is not None:  # this rank's slice of the given cache
                with ranks.use_mesh(mesh):
                    state = {k: ranks.spec_slice(torch.from_numpy(v),
                                                 specs[k]).clone()
                             for k, v in given[i].items()}
            tracer = Tracer()
            prev = set_tracer(tracer)
            try:
                with recorded_collectives() as recs:
                    logits, state = api.decode_step(
                        params, torch.from_numpy(tok[rows]), cfg, state,
                        rules)
            finally:
                set_tracer(prev)
            if records is None:
                records, spans = recs, _span_counts(tracer)
            got.append(logits.float().numpy())
            if given is not None:  # the whole cache the ranks wrote
                with ranks.use_mesh(mesh):
                    wrote.append({k: ranks.spec_gather(v, specs[k]).numpy()
                                  for k, v in state.items()})
        flat, flat_specs = _flat(state), _flat(specs)
        whole = None
        if given is None:
            with ranks.use_mesh(mesh):
                whole = {k: ranks.spec_gather(v, flat_specs[k]).float()
                         .numpy() for k, v in flat.items()}
        out.append({"label": label, "rows": (rows.start, rows.stop),
                    "logits": got, "wrote": wrote if given else None,
                    "state": whole,
                    "cache_shapes": {k: tuple(v.shape)
                                     for k, v in flat.items()},
                    "collectives": records, "spans": spans})
    return out


def _tp_window(mesh, cases) -> list:
    """A dense sliding window in one decode step of a layer's
    ``_attention_block`` over a cache split by sequence (``shard_seq``):
    each rank on its rows, its heads and its run of the given whole cache
    (a layer axis of one in front, sliced by ``state_specs``), with the
    reference's parameters carried onto it; the block's output."""
    from repro_torch.convert import params_from_reference
    from repro_torch.models import api, kvcache, transformer

    out = []
    for label, window, cfg, np_params, x, positions, cache in cases:
        b = x.shape[0]
        rules = rules_for(cfg, mesh, "tp", global_batch=b, shard_seq=True)
        lp = params_from_reference(np_params, cfg, "cpu", rules).layers[0]
        specs = api.state_specs(cfg, rules)
        with ranks.use_mesh(mesh):
            n = b // ranks.axis_size("data")
            rows = slice(ranks.axis_index("data") * n,
                         (ranks.axis_index("data") + 1) * n)
            cache_l = {k: ranks.spec_slice(torch.from_numpy(v)[None],
                                           specs[k])[0].clone()
                       for k, v in cache.items()}
        run = kvcache.cache_run(cache_l, rules)
        got, _ = transformer._attention_block(
            lp, torch.from_numpy(x[rows]), cfg, rules,
            torch.from_numpy(positions[rows]), "decode", cache_l,
            window=window, run=run)
        out.append({"label": label, "window": window, "run": run,
                    "rows": (rows.start, rows.stop), "out": _np(got)})
    return out


def seq_decode_collectives(device, cfg, shape: tuple, tokens, step,
                           max_len: int) -> dict:
    """A prefill of ``tokens`` and one decode step of ``step`` on a
    ``("data", "model")`` mesh of ``shape`` under ``shard_seq`` (this
    rank's rows and its run of the cache): the decode step's collectives
    as a recording mesh records them, and its ``collective:*`` spans."""
    from repro_torch.models import api

    mesh = make_mesh(shape, ("data", "model"))
    b = tokens.shape[0]
    rules = rules_for(cfg, mesh, "tp", global_batch=b, shard_seq=True)
    params = api.init_params(torch.Generator().manual_seed(0), cfg, "cpu",
                             rules)
    with ranks.use_mesh(mesh):
        n = b // ranks.axis_size("data")
        rows = slice(ranks.axis_index("data") * n,
                     (ranks.axis_index("data") + 1) * n)
    state = api.init_decode_state(cfg, n, max_len, "cpu", rules)
    _, state = api.prefill(params, {"tokens": torch.from_numpy(
        tokens[rows])}, cfg, state, rules)
    tracer = Tracer()
    prev = set_tracer(tracer)
    try:
        with recorded_collectives() as records:
            api.decode_step(params, torch.from_numpy(step[rows]), cfg,
                            state, rules)
    finally:
        set_tracer(prev)
    return {"records": records, "spans": _span_counts(tracer)}


def _span_counts(tracer) -> dict:
    """Calls and bytes of each ``collective:*`` span of ``tracer``, as the
    dry run counts them."""
    out: dict = {}
    for e in tracer.events:
        if e.get("ph") == "X" and e["name"].startswith("collective:"):
            kind = out.setdefault(e["name"].split(":", 1)[1],
                                  {"calls": 0, "bytes": 0})
            kind["calls"] += 1
            kind["bytes"] += int(e["args"].get("bytes", 0))
    return out


def _tp_engine(mesh, cfg, seed, prompts, max_new, slots=2, temps=None,
               faults=(), np_params=None, shard_seq=False) -> list:
    """The engine over ``mesh`` on this rank's slices: each request's
    (rid, status, tokens), sorted, and the engine's retries and errors
    where ``faults`` (``FaultSpec``s of an injector each rank makes) are
    given.  ``temps``: each request's temperature (None: greedy);
    ``np_params``: the reference's parameters (None: the port's own from
    ``seed``)."""
    from repro_torch.convert import params_from_reference
    from repro_torch.core.faults import FaultInjector
    from repro_torch.models import api
    from repro_torch.serve.engine import Request, ServeEngine

    rules = rules_for(cfg, mesh, "tp", shard_seq=shard_seq)
    params = api.init_params(torch.Generator().manual_seed(seed), cfg,
                             "cpu", rules) if np_params is None else \
        params_from_reference(np_params, cfg, "cpu", rules)
    engine = ServeEngine(params, cfg, slots=slots, max_len=32, rules=rules,
                         seed=seed, device="cpu",
                         fault_injector=FaultInjector(list(faults))
                         if faults else None)
    for rid, p in enumerate(prompts):
        engine.submit(Request(rid=rid, prompt=p, max_new_tokens=max_new,
                              temperature=temps[rid] if temps else 0.0))
    done = engine.run()
    got = sorted((r.rid, r.status, list(r.output)) for r in done)
    if not faults:
        return got
    return got, {k: engine.stats[k] for k in ("retries", "errors")}


def _tp_moe_modes(cases) -> dict:
    """``moe_mlp`` of one layer on this rank's rows of the batch (split
    over the data ranks) with the reference's parameters, over each case's
    mesh, in each mode: its output, its aux and the collectives it
    sent."""
    from repro_torch.convert import params_from_reference
    from repro_torch.models import moe

    out = {}
    for label, shape, cfg, np_params, x in cases:
        mesh = make_mesh(shape, ("data", "model"))
        rules = rules_for(cfg, mesh, "tp", global_batch=x.shape[0])
        lp = params_from_reference(np_params, cfg, "cpu", rules).layers[0]
        with ranks.use_mesh(mesh):
            n = x.shape[0] // ranks.axis_size("data")
            lo = ranks.axis_index("data") * n
        for mode in ("train", "prefill", "decode"):
            with recorded_collectives() as records:
                got, aux = moe.moe_mlp(lp, torch.from_numpy(x[lo:lo + n]),
                                       cfg, rules, mode)
            out["moe_mlp", label, shape, mode] = {
                "rows": (lo, lo + n), "records": list(records),
                "out": _np(got), "aux": float(aux)}
    return out


def _tp_router(mesh, cases) -> dict:
    """For each MoE case: the gradient of the loss, and of the
    load-balance loss alone, reaching each layer's router on this rank's
    slices over ``mesh`` (no data axis), with both losses."""
    from repro_torch.models import api, moe

    out = {}
    for label, cfg, seed, tokens in cases:
        rules = rules_for(cfg, mesh, "tp")
        params = api.init_params(torch.Generator().manual_seed(seed), cfg,
                                 "cpu", rules)
        routers = [lp.router for lp in params.layers]
        for r in routers:
            r.requires_grad_(True)
        toks = torch.from_numpy(tokens)
        loss = api.train_loss(params, {"tokens": toks}, cfg, rules)
        grad = torch.autograd.grad(loss, routers)
        _, _, aux = moe.forward(params, toks, cfg, rules)
        aux_grad = torch.autograd.grad(aux, routers)
        out[label] = {"loss": float(loss), "aux": float(aux),
                      "grad": [g.clone() for g in grad],
                      "aux_grad": [g.clone() for g in aux_grad]}
    return out


def _tp_elastic(state, cfg, directory) -> dict:
    """A state saved on (2, 2) restored onto (1, 4) and (4, 1): each
    rank's restored leaves against its slices of the whole state."""
    mesh = make_mesh((2, 2), ("data", "model"))
    rules = rules_for(cfg, mesh, "tp")
    specs = train_state_specs(cfg, rules)
    import copy
    local = local_train_state(copy.deepcopy(state), cfg, rules, mesh)
    saved_shapes = {k: tuple(p.shape)
                    for k, p in local.params.named_parameters()}
    CheckpointManager(directory).save(3, local, specs=specs)
    out = {"saved_shapes": saved_shapes}
    for shape in ((1, 4), (4, 1)):
        mesh = make_mesh(shape, ("data", "model"))
        rules = rules_for(cfg, mesh, "tp")
        specs = train_state_specs(cfg, rules)
        got, meta = restore_resharded(CheckpointManager(directory), state,
                                      specs, mesh)
        equal, shapes = True, {}
        with ranks.use_mesh(mesh):
            for name, p in got.params.named_parameters():
                want = ranks.spec_slice(
                    dict(state.params.named_parameters())[name].detach(),
                    specs.params[name])
                equal &= p.dtype == want.dtype and torch.equal(p, want)
                shapes[name] = tuple(p.shape)
            for tree in ("master", "mu", "nu"):
                for name, x in getattr(got.opt, tree).items():
                    want = ranks.spec_slice(getattr(state.opt, tree)[name],
                                            specs.opt.master[name])
                    equal &= torch.equal(x, want)
        out[shape] = {"equal": bool(equal), "step": meta["step"],
                      "opt_step": int(got.opt.step), "shapes": shapes}
    return out


def _tp_ops(mesh, inputs) -> dict:
    """The tensor-parallel operators on this rank's slices of ``inputs``,
    with their gradients, for the one-rank autograd to check."""
    from repro_torch.dist import tensor_parallel as tp

    with ranks.use_mesh(mesh):
        m, r = ranks.axis_size("model"), ranks.axis_index("model")
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    cols = lambda a: a[..., r * (a.shape[-1] // m):  # noqa: E731
                       (r + 1) * (a.shape[-1] // m)]
    out = {}
    x = t(inputs["x"]).requires_grad_()
    y = tp.copy_to_model(x, mesh) @ t(cols(inputs["w"]))
    (y * t(cols(inputs["g"]))).sum().backward()
    out["copy"] = (_np(y), _np(x.grad))

    xr = t(cols(inputs["x"])).requires_grad_()
    rows = inputs["w"].shape[0] // m
    z = tp.reduce_from_model(xr @ t(inputs["w"][r * rows:(r + 1) * rows]),
                             mesh)
    (z * t(inputs["g"])).sum().backward()
    out["reduce"] = (_np(z), _np(xr.grad))

    wk = t(cols(inputs["w"])).requires_grad_()
    k = tp.gather_from_model(t(inputs["x"]) @ wk, -1, mesh)
    (k * t(inputs["gk"][r])).sum().backward()
    out["gather"] = (_np(k), _np(wk.grad))

    for z_loss in (0.0, 1e-3):
        lg = t(cols(inputs["logits"])).requires_grad_()
        loss = tp.vocab_parallel_xent(lg, t(inputs["labels"]), z_loss,
                                      mesh)
        (loss * t(inputs["w_tok"])).sum().backward()
        out[f"xent/{z_loss}"] = (_np(loss), _np(lg.grad))

    vl = inputs["table"].shape[0] // m
    table = t(inputs["table"][r * vl:(r + 1) * vl]).requires_grad_()
    rows_out = tp.vocab_parallel_embed(table, t(inputs["labels"]), mesh)
    (rows_out * t(inputs["g_embed"])).sum().backward()
    out["embed"] = (_np(rows_out), _np(table.grad))
    out["rank"] = r
    return out


def tp_suite(device, work: dict) -> dict:
    """Every tensor-parallel case of ``tests/test_torch_tp.py`` on this
    rank: train steps (also by 2 microbatches) and prefill/decode on each
    mesh of ``work["meshes"]`` (and the cases of ``work["seq_serve"]``,
    the dense windows of ``work["windows"]`` and the engines of
    ``work["seq_engines"]`` under ``shard_seq``), the
    engines over a data axis (``work["data_engines"]``), the engines (phi3, granite and each of the RWKV, hybrid and
    encoder-decoder families), the MoE routers' gradients and the operators
    on (1, 4), the elastic restores."""
    out = {"rank": dist.get_rank()}
    for shape in work["meshes"]:
        mesh = make_mesh(shape, ("data", "model"))
        out[("train", shape)] = _tp_train(mesh, work["train"])
        out[("serve", shape)] = _tp_serve(mesh, work["serve"])
        out[("seq", shape)] = _tp_serve(mesh, work["seq_serve"][shape],
                                        shard_seq=True)
        out[("micro", shape)] = _tp_train(mesh, work["micro"],
                                          microbatches=2)
        out[("window", shape)] = _tp_window(mesh, work["windows"])
        for key, case in work["seq_engines"].get(shape, {}).items():
            out["seq_engine", shape, key] = _tp_engine(mesh, *case,
                                                       shard_seq=True)
    for key, shape, shard_seq, case in work["data_engines"]:
        out["data_engine", key] = _tp_engine(
            make_mesh(shape, ("data", "model")), *case, shard_seq=shard_seq)
    mesh = make_mesh((1, 4), ("data", "model"))
    out["engine"] = _tp_engine(mesh, *work["engine"])
    out["moe_engine"] = _tp_engine(mesh, *work["moe_engine"])
    for label, case in work["family_engines"].items():
        out["engine", label] = _tp_engine(mesh, *case)
    out["router"] = _tp_router(mesh, work["router"])
    out.update(_tp_moe_modes(work["moe_modes"]))
    out["ops"] = _tp_ops(mesh, work["ops"])
    out["elastic"] = _tp_elastic(*work["elastic"])
    out["moe_elastic"] = _tp_elastic(*work["moe_elastic"])
    for label, case in work["family_elastic"].items():
        out["elastic", label] = _tp_elastic(*case)
    return out

"""Multi-pod dry run: every (arch x shape x mesh) cell, on the meta device.

For each cell the dry run takes the rules of the production mesh
(``make_production_mesh``, ``rules_for``), builds rank 0's slice of the
state on the ``meta`` device (the params from ``models.api.param_shapes``
cut by their specs, the AdamW state sliced as ZeRO-1 slices it, or the
decode cache), and runs that rank's real train step, prefill or decode step
on the ``meta`` inputs of ``configs.shapes.input_specs``, under a recording
mesh (``dist.ranks.recording``: every collective recorded, none sent), a
FLOP counter and a byte counter (``utils.hlo_analysis``).  It records:

* ``memory``: a rank's bytes of params, optimizer state and cache, from
  the local shapes, not from an allocator (activations are not counted),
  beside one card's ``total_memory``, with ``fits``;
* ``roofline``: FLOPs, the least bytes and collective bytes, and the
  three-term roofline with one H100's rates (``utils.roofline``), so that
  its ``bound_time_s`` is a least time; the eager bytes beside it
  (``eager_bytes_accessed``, ``eager_memory_s``), which bound nothing;
* ``collectives`` by op, and the ``collective:*`` spans by name.

Runs on the meta device by design: it needs no card and allocates no
memory behind the tensors.  The CUDA kernels take no meta tensor, so a
cell runs the plain paths (``attention_impl="xla"``, and for the
recurrences the plain form of the route their kernels take, which the dry
run sets in the models for the cell: ``plain_scans``), as its artifact
says.  The port's layer loop is a Python loop that runs every layer, so
the reference's cost probes (XLA counts a scan's body once) have no
counterpart.

The least bytes of a cell are its rank's state moved once: a train step
reads and writes the params and the optimizer state, a prefill reads the
params and writes the cache, a decode step reads both; and the inputs
read once.  No program of the same step can move fewer.

Every cell the reference runs, runs here, every family over the
``"model"`` axis.  A ``tp`` decode cell of an attention family runs under
``shard_seq``, as the reference's: where the cache's spec splits its
sequence over ``"model"`` (the KV heads whole: gemma-2b, qwen1.5-32b,
granite-moe-1b/3b and internvl2-26b over 16 ranks), a rank's step holds
``1/m`` of the sequence and records the real sequence-split step's
collectives (the combine's three all-reduces a layer, and q's gather
where the heads split into whole heads a rank); where the spec splits the
KV heads instead (phi3-mini, stablelm-3b, whisper-medium), the sequence
stays whole.  The reference's own skips (``long_500k`` for full
attention) are ``SKIP``.

Artifacts land in
``artifacts/dryrun_torch/<arch>__<shape>__<mesh>__<flavor>.json``.

Usage (``python -m repro_torch.launch.dryrun`` and):
    --arch phi3-mini-3.8b --shape train_4k
    --all                  # every cell, 1 pod, over a process a core
    --all --multi-pod      # 2 pods = 512 ranks
    --list                 # show cells and skips
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import multiprocessing
import os
import time
import traceback
from concurrent.futures import ProcessPoolExecutor

import torch
from torch.utils._pytree import tree_leaves

from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.shapes import (
    SHAPE_NAMES,
    SHAPES,
    ShapeSpec,
    applicable,
    spec_inputs,
)
from repro_torch.dist import ranks
from repro_torch.dist.collectives import set_tracer
from repro_torch.dist.sharding import batch_ranks
from repro_torch.kernels.rg_lru.kernel import rg_lru_route
from repro_torch.kernels.rg_lru.ref import rg_lru_chunked_ref
from repro_torch.kernels.rwkv6.kernel import wkv6_route
from repro_torch.kernels.rwkv6.ref import wkv6_chunked_ref
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.rules import rules_for
from repro_torch.models import api as model_api
from repro_torch.models import rglru as model_rglru
from repro_torch.models import rwkv as model_rwkv
from repro_torch.obs.trace import Tracer
from repro_torch.optim import adamw_init
from repro_torch.train.train_loop import (
    TrainState,
    local_train_state,
    make_train_step,
)
from repro_torch.utils.hlo_analysis import (
    CostCounter,
    collective_stats,
    flops_and_bytes,
)
from repro_torch.utils.roofline import HBM_BW, roofline

ARTIFACT_DIR = os.path.join(
    os.path.dirname(__file__), "..", "..", "..", "artifacts", "dryrun_torch"
)

#: ``torch.cuda.get_device_properties(0).total_memory`` of an NVIDIA H100
#: 80GB HBM3, the card a cell's ``memory`` is set beside
CARD_MEMORY_BYTES = 85_017_493_504
#: what a cell runs in place of the CUDA kernels, which take no meta tensor
PLAIN_PATHS = {"attention_impl": "xla",
               "scans": "the plain form of the kernel's route: "
                        "wkv6_chunked_ref, rg_lru_chunked_ref where it is "
                        "chunk, else the step loop (wkv6_ref, rg_lru_ref); "
                        "no card path runs the chunked forms (serving runs "
                        "the kernel of that route, training the step loop)"}


def _route_plain(route, chunked, step):
    """The plain scan of the route the kernel would take on these
    inputs: ``chunked`` for route ``"chunk"``, else ``step``."""
    def scan(*args, **kwargs):
        return (chunked if route(*args) == "chunk" else step)(*args, **kwargs)
    return scan


@contextlib.contextmanager
def plain_scans():
    """The models' plain scans set, for the dry run's cells, to the plain
    form of the route each kernel takes: a chunked scan runs T / 64 steps
    of Python where the step loop runs T (300-370 s a train cell), which
    is all a meta run can spend its time on."""
    saved = model_rwkv.wkv6_ref, model_rglru.rg_lru_ref
    model_rwkv.wkv6_ref = _route_plain(
        lambda r, k, v, *_: wkv6_route(r, v), wkv6_chunked_ref, saved[0])
    model_rglru.rg_lru_ref = _route_plain(
        lambda log_a, gx, *_: rg_lru_route(gx), rg_lru_chunked_ref, saved[1])
    try:
        yield
    finally:
        model_rwkv.wkv6_ref, model_rglru.rg_lru_ref = saved


def _shard_seq(cfg, kind: str, flavor: str) -> bool:
    """Whether the reference's cell splits the decode cache's sequence over
    ``"model"`` (``tp`` decode of an attention family)."""
    return (kind == "decode" and flavor == "tp"
            and cfg.family not in ("rwkv", "hybrid"))


def cell_status(cfg, shape_name: str, mesh: dict,
                flavor: str) -> tuple[str, str]:
    """(``RUN``, ``""``) or (``SKIP``, the reference's reason) for one
    cell."""
    ok, why = applicable(cfg, shape_name)
    if not ok:
        return "SKIP", why
    return "RUN", ""


def _bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _rows(batch: dict, rows: int) -> dict:
    return {k: x.narrow(0, 0, rows) for k, x in batch.items()}


def _spans(tracer) -> dict:
    """Calls and bytes of each ``collective:*`` span."""
    out: dict = {}
    for e in tracer.events:
        if e.get("ph") == "X" and e["name"].startswith("collective:"):
            kind = out.setdefault(e["name"].split(":", 1)[1],
                                  {"calls": 0, "bytes": 0})
            kind["calls"] += 1
            kind["bytes"] += int(e["args"].get("bytes", 0))
    return out


def cell_metrics(cfg, spec: ShapeSpec, mesh: dict, flavor: str, *,
                 shard_seq: bool = False, microbatches: int = 1) -> dict:
    """Rank 0's state and step of one cell on the meta device over
    ``mesh`` ({axis: ranks}): memory, FLOPs, eager and least bytes,
    collectives, spans."""
    cfg = dataclasses.replace(cfg, attention_impl="xla")
    with ranks.recording(mesh) as rec, plain_scans():
        rules = rules_for(cfg, rec, flavor, global_batch=spec.global_batch,
                          shard_seq=shard_seq)
        batch = spec_inputs(cfg, spec)
        rows = spec.global_batch // batch_ranks(rules)
        mine = _rows(batch, rows)
        params = model_api.local_params(model_api.param_shapes(cfg), cfg,
                                        rules)
        memory = {"params_bytes": _bytes(params.parameters()),
                  "opt_bytes": 0, "cache_bytes": 0}
        if spec.kind == "train":
            params.requires_grad_(True)
            state = local_train_state(TrainState(params, adamw_init(params)),
                                      cfg, rules, rec)
            opt = state.opt
            memory["opt_bytes"] = _bytes([opt.step] + [
                x for tree in (opt.master, opt.mu, opt.nu)
                for x in tree.values()])
            step = make_train_step(cfg, rules, rec,
                                   microbatches=microbatches)

            def run():
                step(state, batch)
        else:
            # a VLM prefill prepends its patch embeddings: the cache holds
            # them
            cache_len = spec.seq_len + (
                cfg.n_patches if cfg.family == "vlm" else 0)
            cache = model_api.init_decode_state(cfg, rows, cache_len, "meta",
                                                rules)
            memory["cache_bytes"] = _bytes(
                x for x in tree_leaves(cache) if isinstance(x, torch.Tensor))

            def run():
                if spec.kind == "prefill":
                    model_api.prefill(params, mine, cfg, cache, rules)
                else:
                    model_api.decode_step(params, mine["tokens"], cfg, cache,
                                          rules)
        tracer = Tracer(clock=time.perf_counter)
        prev = set_tracer(tracer)
        t0 = time.perf_counter()
        try:
            with CostCounter() as cost:
                run()
        finally:
            set_tracer(prev)
        seconds = time.perf_counter() - t0
    memory["total_bytes"] = sum(memory.values())
    # a train step reads and writes its state, a prefill or decode step
    # reads the params and writes or reads the cache
    least_bytes = _bytes(mine.values()) + memory["total_bytes"] * (
        2 if spec.kind == "train" else 1)
    memory["card_bytes"] = CARD_MEMORY_BYTES
    memory["fits"] = memory["total_bytes"] <= CARD_MEMORY_BYTES
    memory["note"] = ("a rank's params, optimizer state and cache from "
                      "their local shapes; activations not counted")
    flops, bytes_acc = flops_and_bytes(cost.cost_analysis())
    coll = collective_stats(rec.records)
    tokens = spec.global_batch * (spec.seq_len if spec.kind != "decode"
                                  else 1)
    return {"flops": flops, "bytes_accessed": bytes_acc,
            "least_bytes": least_bytes,
            "collective_bytes": coll.total_operand_bytes,
            "collectives": coll.summary(), "records": list(rec.records),
            "spans": _spans(tracer), "memory": memory, "run_s": seconds,
            "tokens": tokens,
            "model_flops": model_api.model_flops_for(
                cfg, spec.kind, spec.global_batch, spec.seq_len)}


def cell_roofline(m: dict, chips: int = 1) -> dict:
    """The roofline of ``cell_metrics``'s counts for one rank of ``chips``:
    its memory term from the least bytes, so that ``bound_time_s`` is a
    least time, and the eager bytes' time beside it."""
    terms = roofline(m["flops"], m["least_bytes"], m["collective_bytes"],
                     model_flops=m["model_flops"] / chips)
    return {**terms.to_dict(), "bound_time_s": terms.bound_time_s,
            "eager_bytes_accessed": m["bytes_accessed"],
            "eager_memory_s": m["bytes_accessed"] / HBM_BW}


def lower_cell(arch: str, shape_name: str, mesh: dict, flavor: str,
               overrides: dict | None = None) -> dict:
    """One cell's artifact."""
    cfg = get_config(arch)
    microbatches = 1
    if overrides:
        overrides = dict(overrides)
        microbatches = overrides.pop("microbatches", 1)
        cfg = cfg.scaled(**overrides)
    spec = SHAPES[shape_name]
    chips = 1
    for n in mesh.values():
        chips *= n
    m = cell_metrics(cfg, spec, mesh, flavor,
                     shard_seq=_shard_seq(cfg, spec.kind, flavor),
                     microbatches=microbatches)
    return {
        "arch": arch,
        "shape": shape_name,
        "kind": spec.kind,
        "flavor": flavor,
        "mesh": {"axes": list(mesh), "shape": list(mesh.values()),
                 "chips": chips},
        "run_s": round(m["run_s"], 3),
        "paths": PLAIN_PATHS,
        "counts_note": (
            "one rank's eager meta run: FLOPs by FlopCounterMode; "
            "roofline bytes_accessed is the least bytes (the rank's state "
            "and inputs moved once), eager_bytes_accessed each aten op's "
            "operands and outputs, unfused (an upper bound on a fused "
            "program's, which bounds nothing); every layer runs, so no "
            "cost probes"),
        "collectives": m["collectives"],
        "collective_spans": m["spans"],
        "memory": m["memory"],
        "roofline": cell_roofline(m, chips),
        "tokens": m["tokens"],
    }


def cell_id(arch, shape, multi_pod, flavor):
    mesh_name = "pod2" if multi_pod else "pod1"
    return f"{arch}__{shape}__{mesh_name}__{flavor}"


def _parse_overrides(items) -> dict:
    overrides = {}
    for ov in items:
        k, v = ov.split("=", 1)
        if v.lower() in ("true", "false"):
            overrides[k] = v.lower() == "true"
            continue
        for cast in (int, float):
            try:
                overrides[k] = cast(v)
                break
            except ValueError:
                continue
        else:
            overrides[k] = v
    return overrides


def _cell(arch: str, shape: str, mesh: dict, flavor: str, overrides: dict,
          path: str) -> tuple[str, str]:
    """Run one cell and write its artifact to ``path``; (``PASS``, the
    line to print) or (``FAIL``, the error and its traceback).  A worker
    of ``run_cells``'s pool runs it."""
    try:
        art = lower_cell(arch, shape, mesh, flavor, overrides=overrides)
    except Exception as e:  # noqa: BLE001 - every cell is tried
        return "FAIL", f"{e!r}\n{traceback.format_exc()}"
    with open(path, "w") as f:
        json.dump(art, f, indent=2)
    r, mem = art["roofline"], art["memory"]
    return "PASS", (
        f"run={art['run_s']}s flops/rank={r['flops']:.3e} "
        f"least_bytes/rank={r['bytes_accessed']:.3e} "
        f"eager_bytes/rank={r['eager_bytes_accessed']:.3e} "
        f"coll/rank={r['collective_bytes']:.3e} dominant={r['dominant']} "
        f"frac={r['roofline_fraction']:.3f} "
        f"mem/rank={mem['total_bytes'] / 1e9:.2f}GB fits={mem['fits']}")


def _pooled(pool, todo: list) -> list:
    futures = [(cid, pool.submit(_cell, *a)) for cid, a in todo]
    return [(cid, f.result()) for cid, f in futures]


def run_cells(cells, mesh: dict, flavor: str, out_dir: str, *,
              multi_pod: bool = False, overrides: dict | None = None,
              tag: str = "", skip_existing: bool = False, pool=None,
              echo: bool = True) -> dict:
    """Every (arch, shape) of ``cells`` over ``mesh``: its artifact (or
    skip record) in ``out_dir``, a line printed for each where ``echo``;
    the cells to run go to ``pool`` where given (an executor whose
    processes other work shares; the processes then reported None), else
    more than one is spread over a process for each core this process may
    use.  Returns the counts of each status, the processes, the failures
    and the seconds."""
    say = print if echo else (lambda *a, **k: None)
    t0 = time.perf_counter()
    os.makedirs(out_dir, exist_ok=True)
    tally = {"PASS": 0, "SKIP": 0, "FAIL": 0, "HAVE": 0}
    todo = []
    for arch, shape in cells:
        status, why = cell_status(get_config(arch), shape, mesh, flavor)
        cid = cell_id(arch, shape, multi_pod, flavor)
        if tag:
            cid += "__" + tag
        path = os.path.join(out_dir, cid + ".json")
        if status != "RUN":
            with open(path, "w") as f:
                json.dump({"arch": arch, "shape": shape, "skipped": True,
                           "status": status, "reason": why}, f, indent=2)
            tally[status] += 1
            say(f"{status} {cid}: {why}", flush=True)
        elif skip_existing and os.path.exists(path):
            tally["HAVE"] += 1
            say(f"HAVE {cid}", flush=True)
        else:
            todo.append((cid, (arch, shape, mesh, flavor, overrides or {},
                               path)))
    processes = None if pool is not None else max(
        1, min(len(os.sched_getaffinity(0)), len(todo)))
    if pool is not None:
        results = _pooled(pool, todo)
    elif processes > 1:
        with ProcessPoolExecutor(
                max_workers=processes,
                mp_context=multiprocessing.get_context("spawn")) as own:
            results = _pooled(own, todo)
    else:
        results = [(cid, _cell(*a)) for cid, a in todo]
    failures = []
    for cid, (status, text) in results:
        tally[status] += 1
        if status == "FAIL":
            failures.append((cid, text))
        say(f"{status} {cid}: {text}", flush=True)
    return {"cells": len(cells), **tally, "processes": processes,
            "failures": failures,
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape", choices=SHAPE_NAMES)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--flavor", default="tp", choices=("tp", "dp"))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument(
        "--override", action="append", default=[],
        help="cfg field override key=value (e.g. remat_policy=dots, "
             "microbatches=4)")
    ap.add_argument("--tag", default="",
                    help="artifact filename suffix for variants")
    args = ap.parse_args(argv)
    overrides = _parse_overrides(args.override)
    mesh = make_production_mesh(multi_pod=args.multi_pod)

    cells = []
    if args.all:
        cells = [(arch, shape) for arch in ARCHS for shape in SHAPE_NAMES]
    elif args.arch and args.shape:
        cells.append((args.arch, args.shape))
    else:
        args.list = True

    if args.list:
        print(f"mesh: {mesh}, flavor={args.flavor}")
        print(f"{'arch':28s} {'shape':12s} status")
        for arch in ARCHS:
            cfg = get_config(arch)
            for shape in SHAPE_NAMES:
                status, why = cell_status(cfg, shape, mesh, args.flavor)
                print(f"{arch:28s} {shape:12s} "
                      f"{status if not why else status + ': ' + why}")
        return 0

    out_dir = args.out or os.path.abspath(ARTIFACT_DIR)
    print(f"mesh: {mesh} ({len(cells)} cells), flavor={args.flavor}, "
          f"on the meta device", flush=True)
    res = run_cells(cells, mesh, args.flavor, out_dir,
                    multi_pod=args.multi_pod, overrides=overrides,
                    tag=args.tag, skip_existing=args.skip_existing)
    failures = res.pop("failures")
    print(json.dumps(res))
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for cid, err in failures:
            print(f"  {cid}: {err[:200]}")
        return 1
    print("\nALL CELLS PASSED")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

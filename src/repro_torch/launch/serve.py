"""Serving driver: batched requests through the ServeEngine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \\
        --smoke --requests 8 --prompt-len 32 --max-new 16

runs on the GPU; ``--device cpu`` is the only way to run it on the CPU.
``--mesh 1,4`` serves over 4 ranks on a ``("data", "model")`` mesh of
(1, 4), every family's layers tensor-parallel over ``"model"`` (each rank
its slices of the parameters and of the decode state, ``rules_for``
"tp"): one card a rank where there are as many (NCCL), else every rank on
the first card under gloo; ``--device cpu`` puts the ranks on the CPU
(gloo).  ``--mesh 2,2`` splits the slots over 2 data ranks as well, and
``--shard-seq`` splits the decode cache's sequence over ``"model"`` where
its spec keeps the KV heads whole (``rules_for(..., shard_seq=True)``, as
the reference's flag):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \
        --smoke --device cpu --mesh 1,4 --shard-seq
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.dist import ranks
from repro_torch.launch.mesh import parse_mesh, spawn_backend
from repro_torch.models import init_params
from repro_torch.serve.engine import Request, ServeEngine


def run_serving(
    arch: str,
    *,
    smoke: bool = True,
    requests: int = 8,
    prompt_len: int = 32,
    max_new: int = 16,
    slots: int = 4,
    seed: int = 0,
    device: torch.device | str | None = None,
    mesh: tuple[int, int] | None = None,
    shard_seq: bool = False,
) -> dict:
    """Random parameters from ``seed`` and ``requests`` random prompts
    through the engine on ``device`` (None: the GPU).  With ``mesh`` (data,
    model), over that many ranks (``spawn_backend``), every rank with its
    slices (``shard_seq``: the cache's sequence split over ``"model"``):
    rank 0's result, the ranks' sampled tokens required equal."""
    kw = dict(smoke=smoke, requests=requests, prompt_len=prompt_len,
              max_new=max_new, slots=slots, seed=seed, shard_seq=shard_seq)
    if mesh is not None:
        world = mesh[0] * mesh[1]
        backend, where = spawn_backend(device, world)
        out = ranks.spawn(_serve_rank, world, backend=backend, device=where,
                          args=(arch, kw, tuple(mesh)))
        if any(o.pop("outputs") != out[0]["outputs"] for o in out[1:]):
            raise RuntimeError("the ranks sampled different tokens")
        out[0].pop("outputs")
        return {**out[0], "mesh": list(mesh), "backend": backend or "nccl"}
    out = _serve(arch, device=resolve_device(device), **kw)
    out.pop("outputs")
    return out


def _serve_rank(device, arch: str, kw: dict, mesh_shape: tuple) -> dict:
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh(mesh_shape, ("data", "model"))
    return _serve(arch, device=device, mesh=mesh, **kw)


def _serve(arch: str, *, smoke: bool, requests: int, prompt_len: int,
           max_new: int, slots: int, seed: int, device: torch.device,
           shard_seq: bool = False, mesh=None) -> dict:
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    rules = None
    max_len = prompt_len + max_new + 8
    if shard_seq and mesh is not None:
        # a run of whole positions for each rank of "model"
        m = ranks.mesh_sizes(mesh)["model"]
        max_len = -(-max_len // m) * m
    if mesh is not None:
        from repro_torch.launch.rules import rules_for

        rules = rules_for(cfg, mesh, "tp", shard_seq=shard_seq)
    elif shard_seq:
        raise ValueError("--shard-seq splits the cache over a mesh: give "
                         "--mesh")
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_params(gen, cfg, device, rules)
    engine = ServeEngine(params, cfg, slots=slots, max_len=max_len,
                         rules=rules, seed=seed, device=device)
    rng = np.random.default_rng(seed)
    t0 = time.time()
    for rid in range(requests):
        engine.submit(Request(
            rid=rid,
            prompt=rng.integers(0, cfg.vocab, prompt_len).astype(np.int32),
            max_new_tokens=max_new,
        ))
    done = engine.run()
    dt = time.time() - t0
    return {
        "arch": cfg.name,
        "completed": len(done),
        "decode_tokens": engine.stats["decode_tokens"],
        "prefill_tokens": engine.stats["prefill_tokens"],
        "wall_s": round(dt, 3),
        "tokens_per_s": round(
            (engine.stats["decode_tokens"] + engine.stats["prefill_tokens"])
            / max(dt, 1e-9), 1,
        ),
        "outputs": {r.rid: list(r.output) for r in done},
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' to run on "
                         "the CPU)")
    ap.add_argument("--mesh", default=None,
                    help="DATA,MODEL: serve over that many ranks on a "
                         "('data', 'model') mesh, tensor-parallel over "
                         "'model', the slots split over 'data' (such as "
                         "1,4 or 2,2)")
    ap.add_argument("--shard-seq", action="store_true",
                    help="split the decode cache's sequence over 'model' "
                         "where its spec keeps the KV heads whole (the "
                         "flash-decode distribution)")
    args = ap.parse_args(argv)
    print(json.dumps(run_serving(
        args.arch, smoke=args.smoke, requests=args.requests,
        prompt_len=args.prompt_len, max_new=args.max_new, slots=args.slots,
        seed=args.seed, device=args.device, mesh=parse_mesh(args.mesh),
        shard_seq=args.shard_seq), indent=2))


if __name__ == "__main__":
    main()

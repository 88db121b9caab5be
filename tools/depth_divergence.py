#!/usr/bin/env python3
"""How far two correct paths through a model part as depth grows.

    PYTHONPATH=src python3 tools/depth_divergence.py [--arch rwkv6-3b] \
        [--tokens 1024] [--seed 0]

Needs one GPU.  Random weights from ``--seed`` at the config's full width
and depth (as ``chip_smoke.py`` makes them) and one random prompt go
through four paths: the hand-written kernels (``attention_impl="cuda"``)
and the plain versions (``"naive"``), each in bf16 and with the same
weights widened to f32.  For each path against the f32 kernel path it
prints the relative difference (Frobenius) of every residual block's
output, and the largest difference of the logits over the largest logit,
with the share of positions whose top token agrees: for the model's own
logits, and for the logits that the final norm and head give after every
block (``block_logits``, the logits of a model cut to that depth); the two
bf16 paths against each other likewise.  A model that amplifies rounding
through depth shows it as a difference that grows block by block in f32
too, where the two paths differ only in the order of the kernels' sums; a
full-depth comparison of its logits then says nothing about the kernels,
and ``block_logits`` says to what depth such a comparison still holds.
For an MoE model each path also reports, block by block, the share of
tokens whose top-k experts agree with the f32 kernel path's
(``expert_agree``), and a fifth path, the plain bf16 path with the bf16
kernel path's experts replayed (``chip_smoke.routing``), is held against
the bf16 kernel path: its logits part by rounding alone, with no expert
swapped.  Prints one JSON line per architecture, then the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

from chip_smoke import logits_gap, recorded, routing  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import moe, rglru, rwkv, transformer  # noqa: E402
from repro_torch.models.layers import apply_norm  # noqa: E402

#: where each family's residual stream can be read after a block: the
#: functions whose calls end a block, and which of their calls do
BLOCK_ENDS = {
    "dense": ([(transformer, "_layer_fn")], lambda args: True),
    "vlm": ([(transformer, "_layer_fn")], lambda args: True),
    "moe": ([(moe, "_layer_fn")], lambda args: True),
    # rwkv.forward constrains the residual stream at the end of each layer
    "rwkv": ([(rwkv, "constrain")],
             lambda args: args[2] == ("batch", "seq", "d_model")),
    "hybrid": ([(rglru, "_rec_block"), (rglru, "_attn_block_train")],
               lambda args: True),
}


@contextlib.contextmanager
def block_outputs(cfg):
    """The residual stream after every block of a forward pass, in the
    order the blocks ran, in the list it yields (filled as the block
    exits)."""
    ends, wanted = BLOCK_ENDS[cfg.family]
    calls = []
    with contextlib.ExitStack() as stack:
        for mod, name in ends:
            stack.enter_context(recorded(mod, name, calls))
        seen = []
        yield seen
    for args, _, result in calls:
        if wanted(args):
            seen.append(result[0] if isinstance(result, tuple) else result)


def head(params, x: torch.Tensor, cfg) -> torch.Tensor:
    """The final norm and the output head, as the model's forward ends."""
    x = apply_norm(x, params.final_norm, cfg.norm)
    w = getattr(params, "lm_head", None)
    return (x @ (params.embed.T if w is None else w)).float()


@torch.no_grad()
def divergence(arch: str, tokens: int, seed: int,
               device: torch.device) -> dict:
    cfg = get_config(arch)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = api.init_params(gen, cfg, device)
    toks = torch.randint(0, cfg.vocab, (1, tokens), generator=gen,
                         device=device, dtype=torch.int32)
    runs, routes = {}, {}
    paths = [("cuda_bf16", cfg.dtype, "cuda"),
             ("naive_bf16", cfg.dtype, "naive"),
             ("cuda_f32", "float32", "cuda"),
             ("naive_f32", "float32", "naive")]
    if cfg.family == "moe":
        paths.insert(2, ("naive_bf16_replayed", cfg.dtype, "naive"))
    for label, dtype, impl in paths:
        if dtype == "float32":
            params.float()  # in place: the same weights, widened exactly
        c = cfg.scaled(dtype=dtype, attention_impl=impl)
        replay = routes["cuda_bf16"] if label.endswith("replayed") else None
        with block_outputs(c) as blocks, routing(replay) as seen:
            logits = api.forward(params, toks, c, mode="train")[0].float()
        runs[label] = ([b.float() for b in blocks], logits)
        routes[label] = seen
        del blocks
    ref_blocks, ref_logits = runs["cuda_f32"]
    out = {"arch": arch, "tokens": tokens, "blocks": len(ref_blocks)}

    def block_logits(blocks, against):
        return [logits_gap(head(params, a, cfg), head(params, b, cfg))
                for a, b in zip(blocks, against)]

    def expert_agree(a, b):
        return [float((x.sort(-1).values == y.sort(-1).values).all(-1)
                      .double().mean()) for x, y in zip(a, b)]

    for label, (blocks, logits) in runs.items():
        if label in ("cuda_f32", "naive_bf16_replayed"):
            continue
        out[label] = {
            "block_rel": [float((a - b).norm() / b.norm())
                          for a, b in zip(blocks, ref_blocks)],
            "logits": logits_gap(logits, ref_logits),
            "block_logits": [g["rel_to_max"] for g in
                             block_logits(blocks, ref_blocks)]}
        if routes[label]:
            out[label]["expert_agree"] = expert_agree(routes[label],
                                                      routes["cuda_f32"])
    bf16 = runs["cuda_bf16"]
    for label in ("naive_bf16", "naive_bf16_replayed"):
        if label not in runs:
            continue
        plain16 = runs[label]
        out[f"cuda_bf16_vs_{label}"] = dict(
            logits_gap(bf16[1], plain16[1]),
            block_logits=[g["rel_to_max"] for g in
                          block_logits(bf16[0], plain16[0])])
        if routes[label]:
            out[f"cuda_bf16_vs_{label}"]["expert_agree"] = expert_agree(
                routes["cuda_bf16"], routes[label])
    del params
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", action="append", choices=ARCHS,
                    help="repeatable (default: rwkv6-3b, recurrentgemma-2b "
                         "and phi3-mini-3.8b)")
    ap.add_argument("--tokens", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("depth_divergence: no CUDA device: this tool needs one GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    for arch in args.arch or ["rwkv6-3b", "recurrentgemma-2b",
                              "phi3-mini-3.8b"]:
        print(json.dumps(divergence(arch, args.tokens, args.seed, device)),
              flush=True)
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())

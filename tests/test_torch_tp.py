"""Tensor parallelism over a ``"model"`` axis for every family (dense, VLM,
MoE, RWKV-6, the RecurrentGemma hybrid and the Whisper encoder-decoder)
against the reference's GSPMD, on the CPU.

The reference runs on 4 fake devices in one subprocess
(``tests/_subproc.run_with_devices``, in a thread), the port on 4 gloo
ranks (``repro_torch.dist.ranks.spawn``, rank bodies in
``tests/_torch_dist_ranks.py``, which imports no JAX), both on
``("data", "model")`` meshes of (2, 2) and (1, 4):

* one train step of the phi3-mini-3.8b, gemma-2b and granite-moe-1b smoke
  configs (granite's 4 experts split over the axis, and with 5 experts,
  which neither mesh divides, whole with d_ff split; both teacher-forced
  at ``capacity_factor`` 8) from the
  reference's state at step 60 (moments from numpy) on 8 x 16 tokens,
  under ``rules_for`` "tp": the loss at rtol 1e-5, the gradient norm at
  1e-4, every master, moment and gathered param leaf within
  1e-6 + 1e-4 |x|, against the reference's GSPMD step and the port's
  one-rank step;
* a prefill of 2 x 8 tokens and three decode steps (teacher-forced) of the
  phi3, gemma (MQA: its one KV head gathered whole), qwen (QKV biases, the
  int8 cache, each decode step from a given cache: ``_int8_states``) and
  internvl2 (patch embeddings; at (1, 4) half a KV head a
  rank) and both granite placements' smoke configs and phi3's at vocab
  250 (which 4 does not divide,
  so (1, 4) keeps the vocab whole), against the reference's ``prefill``
  and ``decode_step`` jitted with ``in_shardings`` of the params' and the
  cache's specs (``tests/test_dryrun_small.py``'s construction, run), at
  1e-4;
* phi3 with 2 heads of 16, so that at (1, 4) a rank's query columns are
  half a head (gathered whole, every head attended, each rank keeping its
  columns of the output, as at (16, 16) for gemma-2b, qwen1.5-32b and
  granite-moe-3b), trained and served;
* the rwkv6-3b, recurrentgemma-2b and whisper-medium smoke configs trained
  and served the same way (whisper with random frames), and an rwkv6-3b
  variant with 2 WKV heads of 32, whose columns at (1, 4) are half a head
  (r, k, v and w gathered whole, every head run on the whole state, as
  rwkv6-3b's 2.5 heads a rank at (16, 16)), and a recurrentgemma-2b variant
  with 2 query heads of 32 served (half a head a rank, as its 2.5 at (1,
  4)); the hybrid's ``w_in`` holds on each rank its part of z and of y;
* the decode cache split by sequence over ``"model"`` (the reference's
  ``shard_seq``), ``max_len`` 24: a prefill of 2 x 8 tokens and three
  teacher-forced decode steps of the gemma-2b smoke config at (1, 4) (runs
  of 6 positions: the prompt straddles the first two, the decode writes
  land in the second, the last two stay empty) and (2, 2), of
  qwen1.5-32b's with 2 KV heads (the int8 cache, each step from a given
  cache), granite-moe-1b's, internvl2-26b's and whisper-medium's with 2
  heads of 32 at (1, 4), and phi3's, whose spec splits the KV heads and
  keeps the sequence whole, against the reference's GSPMD under
  ``rules_for(..., shard_seq=True)`` at 1e-4, the cache gathered by
  ``state_specs`` equal to the reference's; and recurrentgemma-2b's with
  its ring of 16 slots split by sequence at (1, 4) and (2, 2), a 14-token
  prompt whose decode steps wrap the ring and a 20-token one whose
  prefill does;
* a dense sliding window through ``_attention_block`` in decode mode over
  a cache split by sequence (gemma-2b's, and qwen1.5-32b's int8 cache),
  against the reference's ``_attention_block`` on one device at 1e-4;
* the engine on (1, 4): greedy tokens equal to the one-rank engine's, and
  the same on every rank, for phi3, granite, rwkv6-3b, recurrentgemma-2b
  and whisper-medium; and the phi3, gemma, granite-moe-1b and
  granite-moe-3b engines over a data axis, on (2, 2), (4, 1) and (2, 2)
  with ``shard_seq``, 4 slots and 6 requests (greedy and by temperature,
  with and without injected faults): the tokens, statuses, retries and
  errors of the one-rank engine, on every rank, the MoE engines on the
  reference's parameters also its request 0's tokens; the other six
  families' engines on (2, 2) and (4, 1), clean; recurrentgemma-2b's engine with its ring split by sequence on
  (1, 4) and (2, 2), by both attention paths, short prompts spliced into
  rows whose ring was full;
* ``moe_mlp`` of one layer with the batch split over the data ranks of
  (2, 2) and (4, 1), on the reference's parameters: two all-reduces over
  the data axis in ``"train"`` mode (``aux`` the reference's GSPMD
  value), none in ``"prefill"`` and ``"decode"``;
* the phi3 and gemma train steps by 2 microbatches on both meshes: the
  one-rank step's loss and gradient norm;
* a train state saved on (2, 2) restored onto (1, 4), (4, 1) and one rank,
  bit for bit, for phi3, granite (its experts split on (2, 2)), rwkv6-3b,
  recurrentgemma-2b (its blocked ``w_in``) and whisper-medium;
* the dry run of each train step on the meta device
  (``launch.dryrun.cell_metrics``) records the all-reduces and
  all-gathers the real step sent, op for op and byte for byte;
* the router's gradient over (1, 4), of the loss and of the load-balance
  loss alone, equal to one rank's for both placements (the replicated
  probabilities reach the router once, not once a rank);
* the autograd operators (``copy_to_model``, ``reduce_from_model``,
  ``gather_from_model``, the vocab-split embedding and cross-entropy)
  against one-rank autograd.
"""

from __future__ import annotations

import collections
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as r_smoke
from repro.models import api as r_api
from repro.optim.adamw import AdamWState as RAdamWState
from repro.train import train_loop as r_train
from repro_torch.ckpt import CheckpointManager, restore_resharded
from repro_torch.configs import get_smoke_config
from repro_torch.convert import (
    config_from_reference,
    params_from_reference,
    train_state_from_reference,
)
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.core.faults import FaultInjector, FaultSpec, RecoveryPolicy
from repro_torch.dist import ranks
from repro_torch.launch import dryrun
from repro_torch.launch.rules import rules_for
from repro_torch.models import api, kvcache, rglru
from repro_torch.models.layers import softmax_xent
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.train.train_loop import (
    init_train_state,
    make_train_step,
    train_state_specs,
)

from _subproc import run_with_devices
import _torch_dist_ranks

N = 4
MESHES = [(2, 2), (1, 4)]
#: the MoE cases' overrides: no token dropped, so that routing flips
#: between two correct runs move no token past a capacity
MOE = {"capacity_factor": 8.0}
HALF_HEADS = {"n_heads": 2, "n_kv_heads": 2}
#: rwkv6-3b with 2 WKV heads of 32: half a head's columns a rank at (1, 4)
RWKV_HALF_HEADS = {"n_heads": 2, "wkv_head_dim": 32}
#: the families added to the dense, VLM and MoE cases: label -> arch
FAMILIES = {"rwkv6-3b": "rwkv6-3b", "recurrentgemma-2b": "recurrentgemma-2b",
            "whisper-medium": "whisper-medium"}
#: train cases: label -> (arch, overrides of its smoke config); granite's
#: 4 experts split over both meshes' "model" axis, its variant's 5 do not
#: (d_ff splits instead)
TRAIN = {"phi3-mini-3.8b": ("phi3-mini-3.8b", {}),
         "gemma-2b": ("gemma-2b", {}),
         # 2 heads of 16: half a head's query columns a rank at (1, 4)
         "phi3-half-heads": ("phi3-mini-3.8b", HALF_HEADS),
         "granite-moe-1b-a400m": ("granite-moe-1b-a400m", MOE),
         "granite-moe-1b-5-experts": ("granite-moe-1b-a400m",
                                      {**MOE, "n_experts": 5}),
         **{label: (arch, {}) for label, arch in FAMILIES.items()},
         "rwkv6-half-heads": ("rwkv6-3b", RWKV_HALF_HEADS)}
TRAIN_ARCHS = list(TRAIN)
MOE_LABELS = ["granite-moe-1b-a400m", "granite-moe-1b-5-experts"]
#: ``moe_mlp`` of one layer over a batch split across the data ranks, in
#: each mode: the meshes and the batch (rows, tokens)
MOE_MODE_MESHES = [(2, 2), (4, 1)]
MOE_MODES = ("train", "prefill", "decode")
MOE_MODE_BATCH = (4, 16)
BATCH, SEQ = 8, 16
#: serve cases: label -> (arch, overrides of its smoke config)
SERVE = {"phi3-mini-3.8b": ("phi3-mini-3.8b", {}),
         "gemma-2b": ("gemma-2b", {}),
         "qwen1.5-32b": ("qwen1.5-32b", {}),
         "internvl2-26b": ("internvl2-26b", {}),
         "phi3-vocab-250": ("phi3-mini-3.8b", {"vocab": 250}),
         "phi3-half-heads": ("phi3-mini-3.8b", HALF_HEADS),
         **{label: TRAIN[label] for label in MOE_LABELS},
         **{label: (arch, {}) for label, arch in FAMILIES.items()},
         "rwkv6-half-heads": ("rwkv6-3b", RWKV_HALF_HEADS),
         # 2 query heads of 32 on one KV head: half a head a rank at (1, 4)
         "recurrentgemma-half-heads": ("recurrentgemma-2b",
                                       {"n_heads": 2, "head_dim": 32})}
PROMPT, DECODE_STEPS, MAX_LEN = (2, 8), 3, 32
#: the serve cases under ``shard_seq``: label -> (arch, overrides, meshes);
#: the cache's sequence splits over "model" where its spec keeps the KV
#: heads whole (every case here but phi3's, whose 4 KV heads split)
SEQ_SERVE = {"seq-gemma-2b": ("gemma-2b", {}, [(1, 4), (2, 2)]),
             "seq-qwen1.5-32b-2-kv-heads": ("qwen1.5-32b", {"n_kv_heads": 2},
                                            [(1, 4)]),
             "seq-granite-moe-1b-a400m": ("granite-moe-1b-a400m", MOE,
                                          [(1, 4)]),
             "seq-internvl2-26b": ("internvl2-26b", {}, [(1, 4)]),
             "seq-whisper-2-heads": ("whisper-medium",
                                     {"n_heads": 2, "n_kv_heads": 2,
                                      "head_dim": 32}, [(1, 4)]),
             "seq-phi3-mini-3.8b": ("phi3-mini-3.8b", {}, [(1, 4)]),
             # the hybrid's ring of 16 slots split into runs of 4 (or 8)
             "seq-recurrentgemma-2b": ("recurrentgemma-2b", {},
                                       [(1, 4), (2, 2)]),
             "seq-recurrentgemma-2b-long": ("recurrentgemma-2b", {},
                                            [(1, 4)])}
#: serve cases with a prompt and decode steps of their own, (batch,
#: tokens) and steps: the hybrid's ring (the smoke window of 16 slots)
#: wraps from slot 15 to 0 in the decode steps after a 14-token prompt,
#: and in the prefill of a 20-token one
OWN_PROMPTS = {"seq-recurrentgemma-2b": ((2, 14), 4),
               "seq-recurrentgemma-2b-long": ((2, 20), 4)}
SEQ_CASES = [(label, shape) for label, (_, _, meshes) in SEQ_SERVE.items()
             for shape in meshes]
SEQ_MAX_LEN = 24
#: the hybrid's engine under ``shard_seq`` on each mesh: 2 slots, 6
#: requests, so that the short prompts are spliced into rows whose ring
#: was full (the prompts of 18 and 20 tokens)
SEQ_ENGINE_PROMPTS = (18, 3, 20, 5, 2, 9)
SEQ_ENGINE_IMPLS = ("cuda", "xla")
#: a dense sliding window through ``_attention_block`` in decode mode
#: over a cache of ``SEQ_MAX_LEN`` split by sequence: label -> (arch,
#: overrides) (one KV head, so that the sequence splits on both meshes),
#: each window (its first position inside a run, at a run's edge, past
#: whole runs), each row's new position
WINDOW_ARCHS = {"gemma-2b": ("gemma-2b", {}),
                "qwen1.5-32b-int8": ("qwen1.5-32b", {"n_kv_heads": 1})}
WINDOW_SIZES = {"inside": 5, "edge": 6, "past": 3}
WINDOW_POS = (12, 17, 23, 15)
#: the train cases also run by 2 microbatches
MICRO_ARCHS = ["gemma-2b", "phi3-mini-3.8b"]
#: the engines over a data axis: (mesh, shard_seq)
DATA_ENGINE_MESHES = [((2, 2), False), ((4, 1), False), ((2, 2), True)]
DATA_ENGINE_ARCHS = ["phi3-mini-3.8b", "gemma-2b", "granite-moe-1b-a400m",
                     "granite-moe-3b-a800m"]
#: the MoE engines over a data axis take the reference's parameters
#: (``jax.random.key(0)``), and request 0 (greedy) gives the tokens of the
#: reference's engine on one device (and on 4 under GSPMD, on both meshes)
#: on the same prompts, 4 slots and ``max_len`` 32
REFERENCE_FIRST_TOKENS = {"granite-moe-1b-a400m": [19, 62, 226, 69, 29],
                          "granite-moe-3b-a800m": [28, 52, 115, 0, 28]}
#: the other families' engines over a data axis, clean: (mesh, shard_seq)
DATA_FAMILY_ARCHS = ["rwkv6-3b", "recurrentgemma-2b", "whisper-medium",
                     "qwen1.5-32b", "internvl2-26b", "stablelm-3b"]
DATA_FAMILY_MESHES = [((2, 2), False), ((4, 1), False)]
#: each request's temperature, and the faults each rank's injector makes:
#: request 2's prefill fails past its retries (status "error"), request
#: 4's once (retried), and the fourth decode step once (retried)
ENGINE_TEMPS = (0.0, 0.8, 0.0, 0.8, 0.0, 0.8)
ENGINE_FAULTS = (FaultSpec("request", task=2, times=0),
                 FaultSpec("request", task=4, times=1),
                 FaultSpec("decode", at=3, times=1))
#: seconds the ranks, and the reference's subprocess, may take: a guard
#: against a hang, far above their run (about 3 minutes alone)
RANKS_TIMEOUT = 900


def _np(x):
    return x.detach().to(torch.float32).numpy()


def _serve_cfg(label):
    arch, overrides = SERVE[label] if label in SERVE else \
        SEQ_SERVE[label][:2]
    return r_smoke(arch).scaled(**overrides)


def _train_cfg(label):
    arch, overrides = TRAIN[label]
    return r_smoke(arch).scaled(**overrides)


def _with_history(state, rng, step):
    hist = lambda a: rng.standard_normal(a.shape).astype(np.float32) * 1e-3
    mu = jax.tree.map(lambda a: jnp.asarray(hist(a)), state.opt.master)
    nu = jax.tree.map(lambda a: jnp.asarray(hist(a) ** 2 + 1e-8),
                      state.opt.master)
    return r_train.TrainState(state.params, RAdamWState(
        jnp.asarray(step, jnp.int32), state.opt.master, mu, nu))


@functools.lru_cache(maxsize=None)
def _train_reference(label):
    rcfg = _train_cfg(label)
    rng = np.random.default_rng(3)
    state = _with_history(r_train.init_train_state(jax.random.key(0), rcfg),
                          rng, 60)
    toks = rng.integers(0, rcfg.vocab, (BATCH, SEQ)).astype(np.int32)
    batch = {"tokens": toks}
    if rcfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (BATCH, rcfg.enc_frames, rcfg.d_model)).astype(np.float32)
    return rcfg, state, batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _prompt_of(label):
    """A serve case's (batch, tokens) prompt and its decode steps."""
    return OWN_PROMPTS.get(label, (PROMPT, DECODE_STEPS))


def _serve_inputs(label):
    rcfg = _serve_cfg(label)
    rng = np.random.default_rng(5)
    prompt, steps = _prompt_of(label)
    toks = rng.integers(0, rcfg.vocab, prompt).astype(np.int32)
    decode = rng.integers(0, rcfg.vocab, (steps, prompt[0], 1)) \
        .astype(np.int32)
    extra = {}
    if rcfg.family == "vlm":
        extra["patches"] = rng.standard_normal(
            (PROMPT[0], rcfg.n_patches, rcfg.d_model)).astype(np.float32)
    if rcfg.family == "encdec":
        extra["frames"] = rng.standard_normal(
            (PROMPT[0], rcfg.enc_frames, rcfg.d_model)).astype(np.float32)
    return rcfg, toks, decode, extra


def _int8_states(rcfg, toks, decode, max_len=MAX_LEN):
    """The cache before each decode step of the reference's one-device
    chain, for an int8 cache (``kv_quant``), and the one after the last.

    A cache entry is ``round(x / scale)``: an ulp of difference in k or v
    between two correct runs moves it by a whole level where ``x / scale``
    lies at a half.  The reference's own GSPMD chain on (2, 2) and (1, 4)
    parts from its one-device chain by 1.8e-4 in the logits this way on
    these inputs (one ``v_q`` entry), so two runs that each quantize their
    own k and v cannot be held at 1e-4.  So the port's ranks decode each
    step from this given cache and write the new token's entries, and the
    reference's GSPMD step then attends to exactly the cache the port
    wrote (``REFERENCE_GIVEN``, its ``kvcache.update_layer`` replaced by
    the identity in its subprocess): the logits are held at 1e-4, and the
    entries the port wrote within one level of the reference's own, their
    scales at 1e-4."""
    params = r_api.init_params(jax.random.key(1), rcfg)
    state = r_api.init_decode_state(rcfg, toks.shape[0], max_len)
    _, state = r_api.prefill(params, {"tokens": jnp.asarray(toks)}, rcfg,
                             state)
    out = []
    for tok in decode:
        out.append({k: np.asarray(v) for k, v in state.items()})
        _, state = r_api.decode_step(params, jnp.asarray(tok), rcfg, state)
    return out + [{k: np.asarray(v) for k, v in state.items()}]


REFERENCE = r"""
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_smoke_config
from repro.dist.sharding import tree_specs
from repro.launch.rules import rules_for
from repro.models import api
from repro.train import train_loop

def serve_cfg(label):
    arch, overrides = SERVE[label]
    return get_smoke_config(arch).scaled(**overrides)

def serve(label, cfg, mesh, named, tag, shard_seq, max_len):
    data = np.load(f"{DIR}/{label}.serve.npz")
    b = data["tokens"].shape[0]
    rules = rules_for(cfg, mesh, "tp", global_batch=b, shard_seq=shard_seq)
    p_specs = tree_specs(rules, api.params_logical_axes(cfg))
    s_specs = tree_specs(rules, api.state_logical_axes(cfg))
    params = jax.device_put(api.init_params(jax.random.key(1), cfg),
                            named(p_specs))
    rows = NamedSharding(mesh, rules.spec(("batch", None)))
    batch = {"tokens": jnp.asarray(data["tokens"])}
    b_specs = {"tokens": rows}
    for key, name in (("patches", "patch_embeds"), ("frames", "frames")):
        if key in data:
            batch[name] = jnp.asarray(data[key], cfg.jdtype)
            b_specs[name] = NamedSharding(
                mesh, rules.spec(("batch", None, None)))
    prefill = jax.jit(
        lambda p, bt, s: api.prefill(p, bt, cfg, s, rules),
        in_shardings=(named(p_specs), b_specs, named(s_specs)))
    decode = jax.jit(
        lambda p, t, s: api.decode_step(p, t, cfg, s, rules),
        in_shardings=(named(p_specs), rows, named(s_specs)))
    state = jax.device_put(api.init_decode_state(cfg, b, max_len),
                           named(s_specs))
    logits, state = prefill(params, batch, state)
    out = [np.asarray(logits, np.float32)]
    for tok in data["decode"]:
        if "state0_pos" in data:  # the int8 cache: REFERENCE_GIVEN
            break
        state = jax.device_put(state, named(s_specs))
        logits, state = decode(params, jnp.asarray(tok), state)
        out.append(np.asarray(logits, np.float32))
    np.savez(f"{DIR}/{label}.{tag}.serve.out.npz", *out)
    np.savez(f"{DIR}/{label}.{tag}.state.npz",
             *[np.asarray(x, np.float32) for x in jax.tree.leaves(state)])

for shape in MESHES:
    mesh = jax.make_mesh(shape, ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    named = lambda t: jax.tree.map(lambda s: NamedSharding(mesh, s), t,
                                   is_leaf=lambda x: isinstance(x, P))
    tag = "x".join(map(str, shape))
    for arch in TRAIN_ARCHS:
        cfg = get_smoke_config(TRAIN[arch][0]).scaled(**TRAIN[arch][1])
        tree = jax.tree.structure(train_loop.init_train_state(
            jax.random.key(0), cfg))
        data = np.load(f"{DIR}/{arch}.in.npz")
        state = jax.tree.unflatten(tree, [jnp.asarray(data[f"arr_{i}"])
                                          for i in range(tree.num_leaves)])
        rules = rules_for(cfg, mesh, "tp", global_batch=BATCH)
        step = train_loop.make_train_step(cfg, rules, mesh, donate=False)
        batch = {"tokens": jnp.asarray(data["tokens"])}
        if "frames" in data:
            batch["frames"] = jnp.asarray(data["frames"])
        new, m = step(state, batch)
        np.savez(f"{DIR}/{arch}.{tag}.out.npz",
                 *[np.asarray(x) for x in jax.tree.leaves(new)],
                 loss=np.asarray(m["loss"]),
                 grad_norm=np.asarray(m["grad_norm"]),
                 lr=np.asarray(m["lr"]))
    for label in SERVE:
        serve(label, serve_cfg(label), mesh, named, tag, False, MAX_LEN)
    for label, (arch, overrides, shapes) in SEQ.items():
        if tuple(shape) in [tuple(x) for x in shapes]:
            serve(label, get_smoke_config(arch).scaled(**overrides), mesh,
                  named, tag, True, SEQ_MAX_LEN)

from repro.models import moe
for shape in MOE_MODE_MESHES:
    mesh = jax.make_mesh(shape, ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    tag = "x".join(map(str, shape))
    for label in MOE_LABELS:
        cfg = get_smoke_config(TRAIN[label][0]).scaled(**TRAIN[label][1])
        x = jnp.asarray(np.load(f"{DIR}/{label}.moe_mlp.npz")["x"])
        rules = rules_for(cfg, mesh, "tp", global_batch=x.shape[0])
        lp = jax.tree.map(lambda a: a[0],
                          api.init_params(jax.random.key(1), cfg)["layers"])
        rows = NamedSharding(mesh, rules.spec(("batch", None, None)))
        out, aux = jax.jit(lambda p, v: moe.moe_mlp(p, v, cfg, rules),
                           in_shardings=(None, rows))(lp, x)
        np.savez(f"{DIR}/{label}.{tag}.moe_mlp.out.npz",
                 out=np.asarray(out, np.float32),
                 aux=np.asarray(aux, np.float32))
print("REFERENCE-OK")
"""


#: each decode step of an int8-cache case from the cache the port's ranks
#: wrote (its ``pos`` the given one's): the reference's cache write is the
#: identity, so that it attends to exactly that cache
REFERENCE_GIVEN = r"""
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_smoke_config
from repro.dist.sharding import tree_specs
from repro.launch.rules import rules_for
from repro.models import api, kvcache

kvcache.update_layer = lambda cfg, cache_l, k, v, pos: dict(cache_l)
for shape in MESHES:
    mesh = jax.make_mesh(shape, ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    named = lambda t: jax.tree.map(lambda s: NamedSharding(mesh, s), t,
                                   is_leaf=lambda x: isinstance(x, P))
    tag = "x".join(map(str, shape))
    for label, (arch, overrides, shard_seq, shapes) in GIVEN.items():
        if tuple(shape) not in [tuple(x) for x in shapes]:
            continue
        cfg = get_smoke_config(arch).scaled(**overrides)
        data = np.load(f"{DIR}/{label}.serve.npz")
        wrote = np.load(f"{DIR}/{label}.{tag}.wrote.npz")
        rules = rules_for(cfg, mesh, "tp", global_batch=data["tokens"].shape[0],
                          shard_seq=shard_seq)
        p_specs = tree_specs(rules, api.params_logical_axes(cfg))
        s_specs = tree_specs(rules, api.state_logical_axes(cfg))
        params = jax.device_put(api.init_params(jax.random.key(1), cfg),
                                named(p_specs))
        rows = NamedSharding(mesh, rules.spec(("batch", None)))
        decode = jax.jit(
            lambda p, t, s: api.decode_step(p, t, cfg, s, rules),
            in_shardings=(named(p_specs), rows, named(s_specs)))
        out = []
        for i, tok in enumerate(data["decode"]):
            state = {k: jnp.asarray(wrote[f"w{i}_{k}"]) for k in s_specs}
            state["pos"] = jnp.asarray(data[f"state{i}_pos"])
            logits, _ = decode(params, jnp.asarray(tok),
                               jax.device_put(state, named(s_specs)))
            out.append(np.asarray(logits, np.float32))
        np.savez(f"{DIR}/{label}.{tag}.given.out.npz", *out)
print("REFERENCE-GIVEN-OK")
"""


def _carried(rstate, tcfg):
    return train_state_from_reference(jax.tree.map(np.asarray, rstate), tcfg,
                                      "cpu")


def _ops_inputs():
    rng = np.random.default_rng(11)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"x": f(6, 8), "w": f(8, 12), "g": f(6, 12),
            "gk": f(N, 6, 12), "logits": f(10, 16) * 3.0,
            "labels": rng.integers(0, 16, 10).astype(np.int64),
            "w_tok": f(10), "table": f(16, 5), "g_embed": f(10, 5)}


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    """The reference's steps and logits on both meshes (one subprocess, 4
    fake devices), the port's (4 gloo ranks, one spawn) and the port's
    one-rank results."""
    tmp = tmp_path_factory.mktemp("tp")
    work = {"meshes": MESHES, "train": [], "serve": []}
    single = {}
    for arch in TRAIN_ARCHS:
        rcfg, rstate, batch = _train_reference(arch)
        np.savez(tmp / f"{arch}.in.npz",
                 *[np.asarray(x) for x in jax.tree.leaves(rstate)], **batch)
        tcfg = config_from_reference(rcfg)
        tstate = _carried(rstate, tcfg)
        batch = _torch_batch(batch)
        work["train"].append((arch, tcfg, tstate, batch))
        single[arch] = make_train_step(tcfg, donate=False)(tstate, batch)
    work["micro"] = []
    for arch in MICRO_ARCHS:
        tcfg, tstate, batch = next(c[1:] for c in work["train"]
                                   if c[0] == arch)
        work["micro"].append((arch, tcfg, tstate, batch))
        single["micro", arch] = make_train_step(
            tcfg, microbatches=2, donate=False)(tstate, batch)
    # remat over the ranks: the recompute issues the layer's collectives
    # again inside the backward pass, in the same order on every rank
    for policy in ("nothing", "dots"):
        arch = "phi3-mini-3.8b"
        rcfg, rstate, batch = _train_reference(arch)
        tcfg = dataclasses.replace(config_from_reference(rcfg), remat=True,
                                   remat_policy=policy)
        work["train"].append((f"{arch}/remat-{policy}", tcfg,
                              _carried(rstate, tcfg), _torch_batch(batch)))
    for label in SERVE:
        rcfg, toks, decode, extra = _serve_inputs(label)
        inputs = dict(extra)
        states = _int8_states(rcfg, toks, decode) if rcfg.kv_quant else None
        for i, st in enumerate(states or ()):
            extra = {**extra, **{f"state{i}_{k}": v for k, v in st.items()}}
        np.savez(tmp / f"{label}.serve.npz", tokens=toks, decode=decode,
                 **extra)
        np_params = jax.tree.map(lambda a: np.asarray(a, np.float32),
                                 r_api.init_params(jax.random.key(1), rcfg))
        work["serve"].append((label, config_from_reference(rcfg), np_params,
                              toks, decode, inputs, MAX_LEN, states))
    work["seq_serve"] = {shape: [] for shape in MESHES}
    for label, (_, _, meshes) in SEQ_SERVE.items():
        rcfg, toks, decode, extra = _serve_inputs(label)
        inputs = dict(extra)
        states = _int8_states(rcfg, toks, decode, SEQ_MAX_LEN) \
            if rcfg.kv_quant else None
        for i, st in enumerate(states or ()):
            extra = {**extra, **{f"state{i}_{k}": v for k, v in st.items()}}
        np.savez(tmp / f"{label}.serve.npz", tokens=toks, decode=decode,
                 **extra)
        np_params = jax.tree.map(lambda a: np.asarray(a, np.float32),
                                 r_api.init_params(jax.random.key(1), rcfg))
        for shape in meshes:
            work["seq_serve"][shape].append(
                (label, config_from_reference(rcfg), np_params, toks,
                 decode, inputs, SEQ_MAX_LEN, states))
    work["windows"], single["windows"] = _window_cases()
    work["seq_engines"] = {
        shape: {impl: _seq_engine_case(impl) for impl in SEQ_ENGINE_IMPLS}
        for shape in MESHES}
    work["data_engines"] = [
        (key, shape, shard_seq, _data_engine_case(arch, faulty))
        for arch in DATA_ENGINE_ARCHS for shape, shard_seq in
        DATA_ENGINE_MESHES for faulty in (False, True)
        for key in [_data_engine_key(arch, shape, shard_seq, faulty)]]
    work["data_engines"] += [
        (_data_engine_key(arch, shape, shard_seq, False), shape, shard_seq,
         _data_engine_case(arch, False))
        for arch in DATA_FAMILY_ARCHS
        for shape, shard_seq in DATA_FAMILY_MESHES]
    ecfg = get_smoke_config("phi3-mini-3.8b")
    prompts = [np.random.default_rng(i).integers(0, ecfg.vocab, n)
               .astype(np.int32) for i, n in enumerate((5, 9, 3, 7))]
    work["engine"] = (ecfg, 0, prompts, 5)
    work["moe_engine"] = (_moe_cfg(MOE_LABELS[0]), 0, prompts, 5)
    work["family_engines"] = {label: (_moe_cfg(label), 0, prompts, 5)
                              for label in FAMILIES}
    work["router"] = [(label, _moe_cfg(label), 2, _router_tokens())
                      for label in MOE_LABELS]
    work["moe_modes"] = []
    for label in MOE_LABELS:
        rcfg = _train_cfg(label)
        x = np.random.default_rng(19).standard_normal(
            MOE_MODE_BATCH + (rcfg.d_model,)).astype(np.float32)
        np.savez(tmp / f"{label}.moe_mlp.npz", x=x)
        np_params = jax.tree.map(lambda a: np.asarray(a, np.float32),
                                 r_api.init_params(jax.random.key(1), rcfg))
        work["moe_modes"] += [(label, shape, config_from_reference(rcfg),
                               np_params, x) for shape in MOE_MODE_MESHES]
    work["ops"] = _ops_inputs()
    elastic = _elastic_state()
    work["elastic"] = (elastic[1], elastic[0], str(tmp / "ckpt"))
    elastic = _elastic_state(_moe_cfg(MOE_LABELS[0]))
    work["moe_elastic"] = (elastic[1], elastic[0], str(tmp / "moe_ckpt"))
    work["family_elastic"] = {}
    for label in FAMILIES:
        cfg, state = _elastic_state(_moe_cfg(label))
        work["family_elastic"][label] = (state, cfg,
                                         str(tmp / f"{label}_ckpt"))
    code = (f"MESHES = {MESHES!r}\nTRAIN_ARCHS = {TRAIN_ARCHS!r}\n"
            f"TRAIN = {TRAIN!r}\n"
            f"SERVE = {SERVE!r}\nDIR = {str(tmp)!r}\nBATCH = {BATCH}\n"
            f"MAX_LEN = {MAX_LEN}\nSEQ = {SEQ_SERVE!r}\n"
            f"SEQ_MAX_LEN = {SEQ_MAX_LEN}\nMOE_LABELS = {MOE_LABELS!r}\n"
            f"MOE_MODE_MESHES = {MOE_MODE_MESHES!r}\n" + REFERENCE)
    with _torch_dist_ranks.beside(run_with_devices, code, n_devices=N,
                                  timeout=RANKS_TIMEOUT) as out:
        port = ranks.spawn(_torch_dist_ranks.tp_suite, N, backend="gloo",
                           device="cpu", init_dir=str(tmp / "rdv"),
                           args=(work,), timeout=RANKS_TIMEOUT)
    assert "REFERENCE-OK" in out["result"]
    given = {label: (*SERVE[label], False, MESHES) for label in SERVE
             if _serve_cfg(label).kv_quant}
    given.update({label: (arch, overrides, True, meshes)
                  for label, (arch, overrides, meshes) in SEQ_SERVE.items()
                  if _serve_cfg(label).kv_quant})
    for label, (_, _, shard_seq, meshes) in given.items():
        for shape in meshes:
            tag = "x".join(map(str, shape))
            wrote = next(r for r in port[0]["seq" if shard_seq else "serve",
                                             shape]
                         if r["label"] == label)["wrote"]
            np.savez(tmp / f"{label}.{tag}.wrote.npz",
                     **{f"w{i}_{k}": v for i, st in enumerate(wrote)
                        for k, v in st.items()})
    code = (f"MESHES = {MESHES!r}\nGIVEN = {given!r}\n"
            f"DIR = {str(tmp)!r}\n" + REFERENCE_GIVEN)
    assert "REFERENCE-GIVEN-OK" in run_with_devices(code, n_devices=N,
                                                    timeout=300)
    ref = {}
    for shape in MESHES:
        tag = "x".join(map(str, shape))
        for arch in TRAIN_ARCHS:
            rcfg, rstate, _ = _train_reference(arch)
            tree = jax.tree.structure(rstate)
            data = np.load(tmp / f"{arch}.{tag}.out.npz")
            new = jax.tree.unflatten(tree, [data[f"arr_{i}"]
                                            for i in range(tree.num_leaves)])
            ref["train", arch, shape] = (
                _carried(new, config_from_reference(rcfg)),
                {k: float(data[k]) for k in ("loss", "grad_norm", "lr")})
        seq = [label for label, (_, _, meshes) in SEQ_SERVE.items()
               if shape in meshes]
        for label in [*SERVE, *seq]:
            data = np.load(tmp / f"{label}.{tag}.serve.out.npz")
            logits = [data["arr_0"]]
            steps = _prompt_of(label)[1]
            if label in given:
                data = np.load(tmp / f"{label}.{tag}.given.out.npz")
                logits += [data[f"arr_{i}"] for i in range(steps)]
            else:
                logits += [data[f"arr_{i}"] for i in range(1, steps + 1)]
            ref["serve", label, shape] = logits
            data = np.load(tmp / f"{label}.{tag}.state.npz")
            ref["state", label, shape] = [data[f"arr_{i}"]
                                          for i in range(len(data.files))]
    for shape in MOE_MODE_MESHES:
        tag = "x".join(map(str, shape))
        for label in MOE_LABELS:
            data = np.load(tmp / f"{label}.{tag}.moe_mlp.out.npz")
            ref["moe_mlp", label, shape] = (data["out"], float(data["aux"]))
    return ref, port, single, work, str(tmp / "ckpt")


def _window_cases():
    """The dense windows' cases (label, window, config, params, x,
    positions, the whole one-layer cache) for the ranks, and the
    reference's ``_attention_block`` output of each on one device."""
    from repro.models import kvcache as r_kvcache
    from repro.models import transformer as r_transformer

    cases, want = [], {}
    for label, (arch, overrides) in WINDOW_ARCHS.items():
        rcfg = r_smoke(arch).scaled(**overrides)
        rng = np.random.default_rng(17)
        params = r_api.init_params(jax.random.key(1), rcfg)
        np_params = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
        b = len(WINDOW_POS)
        x = rng.standard_normal((b, 1, rcfg.d_model)).astype(np.float32)
        positions = np.asarray(WINDOW_POS, np.int32)[:, None]
        shape = (b, rcfg.n_kv_heads, SEQ_MAX_LEN, rcfg.head_dim)
        if rcfg.kv_quant:
            cache = {k: rng.integers(-127, 128, shape).astype(np.int8)
                     for k in ("k_q", "v_q")}
            cache.update({k: (rng.random(shape[:-1]) * 0.02)
                          .astype(np.float32) for k in ("k_s", "v_s")})
        else:
            cache = {k: rng.standard_normal(shape).astype(np.float32)
                     for k in ("k", "v")}
        assert set(cache) == set(r_kvcache.cache_logical_axes(rcfg)) - {
            "pos"}
        lp = jax.tree.map(lambda a: a[0], params["layers"])
        for case, window in WINDOW_SIZES.items():
            out, _ = r_transformer._attention_block(
                lp, jnp.asarray(x), rcfg, None, jnp.asarray(positions),
                "decode", {k: jnp.asarray(v) for k, v in cache.items()},
                window=window)
            want[label, case] = np.asarray(out, np.float32)
            cases.append((f"{label}/{case}", window,
                          config_from_reference(rcfg), np_params, x,
                          positions, cache))
    return cases, want


def _seq_engine_case(impl):
    """(cfg, seed, prompts, max_new, slots) of the hybrid's engine under
    ``shard_seq`` by ``attention_impl`` ``impl``."""
    cfg = dataclasses.replace(get_smoke_config("recurrentgemma-2b"),
                              attention_impl=impl)
    prompts = [np.random.default_rng(30 + i).integers(0, cfg.vocab, n)
               .astype(np.int32) for i, n in enumerate(SEQ_ENGINE_PROMPTS)]
    return cfg, 0, prompts, 5, 2


def _moe_cfg(label):
    """The port's config of a train case (an MoE one, or one of
    ``FAMILIES``), with the plain attention (the train step refuses the
    CUDA kernels)."""
    arch, overrides = TRAIN[label]
    return dataclasses.replace(get_smoke_config(arch).scaled(**overrides),
                               attention_impl="xla")


def _router_tokens():
    return np.random.default_rng(13).integers(0, 256, (BATCH, SEQ)) \
        .astype(np.int32)


def _close(got, want, what):
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-6,
                               err_msg=what)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_tp_train_step_matches_the_reference_and_one_rank(tp_runs, arch,
                                                          shape):
    ref, port, single, _, _ = tp_runs
    by_rank = [next(r for r in p["train", shape] if r["label"] == arch)
               for p in port]
    got = by_rank[0]
    want_state, want = ref["train", arch, shape]
    one_state, one = single[arch]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["loss"], float(one["loss"]), rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=1e-4)
    np.testing.assert_allclose(got["grad_norm"], float(one["grad_norm"]),
                               rtol=1e-4)
    np.testing.assert_allclose(got["lr"], want["lr"], rtol=1e-6)
    assert got["step"] == int(want_state.step) == 61
    for r in by_rank:  # every rank reports the global batch's numbers
        assert r["loss"] == got["loss"]
        assert r["grad_norm"] == got["grad_norm"]
        # a replicated param (a norm's scale) is the same on every rank
        for name, p in r["replicated"].items():
            assert torch.equal(p, got["replicated"][name]), name
    for tree in ("master", "mu", "nu"):
        mine = got[tree]
        theirs = getattr(want_state.opt, tree)
        one_rank = getattr(one_state.opt, tree)
        assert list(mine) == list(theirs)
        for name in theirs:
            _close(mine[name], theirs[name], f"{arch} {shape} {tree}/{name}")
            _close(mine[name], one_rank[name], f"{arch} {shape} {tree}/{name}")
    for name, p in one_state.params.named_parameters():
        _close(got["params"][name], p, f"{arch} {shape} params/{name}")
        _close(got["params"][name], dict(
            want_state.params.named_parameters())[name],
            f"{arch} {shape} params/{name}")


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("policy", ["nothing", "dots"])
def test_tp_train_step_with_remat_equals_the_step_without(tp_runs, policy,
                                                          shape):
    """Remat under tensor parallelism (both of the reference's policies):
    the loss, the gradient norm and every leaf bit for bit as without it,
    on every rank."""
    _, port, _, _, _ = tp_runs
    for p in port:
        plain = next(r for r in p["train", shape]
                     if r["label"] == "phi3-mini-3.8b")
        remat = next(r for r in p["train", shape]
                     if r["label"] == f"phi3-mini-3.8b/remat-{policy}")
        assert remat["loss"] == plain["loss"]
        assert remat["grad_norm"] == plain["grad_norm"]
        for tree in ("params", "master", "mu", "nu", "replicated"):
            for name, x in plain.get(tree, {}).items():
                assert torch.equal(remat[tree][name], x), (tree, name)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_tp_dry_run_records_the_real_steps_collectives(tp_runs, arch, shape):
    """``launch.dryrun.cell_metrics`` of the same step on the meta device
    (the same config, batch and mesh, rank 0's state built from shapes)
    records, op for op and byte for byte, the all-reduces and all-gathers
    that the real step on 4 gloo ranks sent (rank 0's, and every rank's
    equal).  Each is counted, not ordered: the carried state's parameters
    are registered in the reference tree's key order, the dry run's in the
    port's, and the gradients are reduced leaf by leaf in that order."""
    _, port, _, work, _ = tp_runs
    cfg = next(c[1] for c in work["train"] if c[0] == arch)
    dry = dryrun.cell_metrics(cfg, ShapeSpec("t", SEQ, BATCH, "train"),
                              {"data": shape[0], "model": shape[1]}, "tp")
    real = [next(r for r in p["train", shape] if r["label"] == arch)
            ["collectives"] for p in port]
    assert dry["records"] and all(r == real[0] for r in real)
    assert collections.Counter(dry["records"]) == \
        collections.Counter(real[0])


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_tp_params_are_each_ranks_slice(tp_runs, arch, shape):
    """Each rank holds its share of every leaf the rules split over
    "model" and the whole of the rest; the hybrid's ``w_in`` = [z | y]
    holds the rank's part of z and its part of y (not a contiguous share
    of the two, which would give two ranks halves of z and two halves of
    y), equal to those columns of the whole new leaf."""
    ref, port, single, _, _ = tp_runs
    one_state, _ = single[arch]
    cfg = get_smoke_config(TRAIN[arch][0]).scaled(**TRAIN[arch][1])
    rules = rules_for(cfg, {"data": shape[0], "model": shape[1]}, "tp",
                      global_batch=BATCH)
    specs = train_state_specs(cfg, rules).params
    whole = dict(ref["train", arch, shape][0].params.named_parameters())
    for p in port:
        local = next(r for r in p["train", shape] if r["label"] == arch)
        for name, leaf in one_state.params.named_parameters():
            want = list(leaf.shape)
            for dim, entry in enumerate(specs[name]):
                if entry == "model":
                    want[dim] //= shape[1]
            assert list(local["local_shapes"][name]) == want, name
        assert bool(local["w_in"]) == (cfg.family == "hybrid")
        for name, got in local["w_in"].items():
            w = cfg.d_model
            n = w // shape[1]
            lo = local["model_index"] * n
            z, y = whole[name][:, lo:lo + n], whole[name][:, w + lo:w + lo + n]
            _close(got, torch.cat([z, y], dim=1), f"{arch} {shape} {name}")


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("label", list(SERVE))
def test_tp_prefill_and_decode_match_the_reference(tp_runs, label, shape):
    """The logits of a prefill and each decode step, and (where no cache is
    given) the decode state the ranks hold gathered whole by
    ``api.state_specs``, against the reference's GSPMD at 1e-4; each rank's
    state is its slice of the whole state under those specs (its KV heads
    where the rules split them, its WKV heads where its columns are whole
    heads, its recurrent channels)."""
    _held_to_the_reference(tp_runs, label, shape, "serve", MAX_LEN)


@pytest.mark.parametrize("label,shape", SEQ_CASES,
                         ids=[f"{label}-{'x'.join(map(str, shape))}"
                              for label, shape in SEQ_CASES])
def test_tp_seq_split_prefill_and_decode_match_the_reference(tp_runs, label,
                                                             shape):
    """Under ``shard_seq`` (the reference's flash-decode distribution):
    the logits of a prefill and three decode steps and the cache gathered
    whole by ``api.state_specs`` (an int8 cache: the entries the ranks
    wrote within one level) against the reference's GSPMD at 1e-4; each
    rank's cache holds its run of ``max_len / m`` positions where the
    cache's spec splits the sequence (every KV head), and the whole
    sequence where it splits the KV heads instead (phi3).  gemma at (1, 4):
    runs of 6, the prompt's 8 positions in the first two and the decode
    writes in the second, the last two runs all zeros.  The hybrid's ring
    of 16 slots splits into runs of 4 (8 at (2, 2)) of ``attn_k``,
    ``attn_v`` and ``slot_pos``, through the ring's wrap in the decode
    steps after a 14-token prompt and in the prefill of a 20-token one."""
    rules = _held_to_the_reference(tp_runs, label, shape, "seq",
                                   SEQ_MAX_LEN)
    cfg = config_from_reference(_serve_cfg(label))
    m = shape[1]
    split = rules.spec(("kv_heads",))[0] != "model"
    assert split == (label != "seq-phi3-mini-3.8b")
    key = {"encdec": "self_k", "hybrid": "attn_k"}.get(
        cfg.family, "k_q" if cfg.kv_quant else "k")
    assert api.state_specs(cfg, rules)[key][3] == ("model" if split
                                                   else None)
    assert kvcache.seq_run(rules)[0] == (m if split else 1)
    layers, length = cfg.n_layers, SEQ_MAX_LEN
    if cfg.family == "hybrid":
        layers, length = rglru.n_groups(cfg)[0], cfg.window
        assert api.state_specs(cfg, rules)["slot_pos"][2] == "model"
    _, port, _, _, _ = tp_runs
    for p in port:
        got = next(r for r in p["seq", shape] if r["label"] == label)
        heads = cfg.n_kv_heads // (1 if split else m)
        assert got["cache_shapes"][key] == (
            layers, _prompt_of(label)[0][0] // shape[0], heads,
            length // (m if split else 1), cfg.head_dim)
        if cfg.family == "hybrid":
            assert got["cache_shapes"]["slot_pos"] == (
                layers, _prompt_of(label)[0][0] // shape[0], length // m)
    if label == "seq-gemma-2b" and shape == (1, 4):
        got = next(r for r in port[0]["seq", shape] if r["label"] == label)
        k = got["state"]["k"]  # whole: the ranks' runs of 6 in order
        written = PROMPT[1] + DECODE_STEPS
        assert (np.abs(k[:, :, :, :written]).max(axis=-1) > 0).all()
        assert not k[:, :, :, written:].any()
        assert written <= 2 * SEQ_MAX_LEN // m


def _held_to_the_reference(tp_runs, label, shape, kind, max_len):
    """The prefill's and decode steps' logits of a serve case (``kind``
    "serve", or "seq" under ``shard_seq``) on every rank, and its state,
    against the reference's; returns the rules."""
    ref, port, _, work, _ = tp_runs
    want = ref["serve", label, shape]
    rcfg = _serve_cfg(label)
    cfg = config_from_reference(rcfg)
    prompt, steps = _prompt_of(label)
    mesh = {"data": shape[0], "model": shape[1]}
    rules = rules_for(cfg, mesh, "tp", global_batch=prompt[0],
                      shard_seq=kind == "seq").with_mesh(mesh)
    specs = _torch_dist_ranks._flat(api.state_specs(cfg, rules))
    whole = _torch_dist_ranks._flat(api.init_decode_state(
        cfg, prompt[0] // shape[0], max_len, "meta"))
    for p in port:
        got = next(r for r in p[kind, shape] if r["label"] == label)
        lo, hi = got["rows"]
        assert len(got["logits"]) == steps + 1
        for i, (g, w) in enumerate(zip(got["logits"], want)):
            assert g.shape == w[lo:hi].shape == (hi - lo, 1, rcfg.vocab)
            np.testing.assert_allclose(g, w[lo:hi], rtol=1e-4, atol=1e-4,
                                       err_msg=f"{label} {shape} step {i}")
        if got["wrote"] is not None:
            _check_int8_writes(label, got["wrote"], work, kind)
        else:
            state = ref["state", label, shape]
            assert len(state) == len(got["state"])
            for (name, g), w in zip(got["state"].items(), state):
                np.testing.assert_allclose(
                    g, w, rtol=1e-4, atol=1e-4,
                    err_msg=f"{label} {shape} state {name}")
        assert set(got["cache_shapes"]) == set(whole)
        for name, leaf in whole.items():
            local = list(leaf.shape)
            for dim, entry in enumerate(specs[name]):
                if entry == "model":
                    local[dim] //= shape[1]
            assert got["cache_shapes"][name] == tuple(local), name
        if cfg.family in ("dense", "vlm", "moe"):
            # the cache holds this rank's KV heads where the rules split
            # them
            split = rules.spec(("kv_heads",))[0] == "model"
            heads = rcfg.n_kv_heads // (shape[1] if split else 1)
            cache = got["cache_shapes"]["k_q" if rcfg.kv_quant else "k"]
            assert cache == (rcfg.n_layers, PROMPT[0] // shape[0], heads,
                             max_len // kvcache.seq_run(rules)[0],
                             rcfg.head_dim)
    return rules


def _check_int8_writes(label, wrote, work, kind="serve"):
    """The int8 entries and scales the port's ranks wrote for each decode
    step's token, against the reference's one-device chain's: the entries
    within one level, the scales at 1e-5."""
    cases = work["serve"] if kind == "serve" else \
        [c for by_shape in work["seq_serve"].values() for c in by_shape]
    states = next(c for c in cases if c[0] == label)[-1]
    for i, mine in enumerate(wrote):
        pos = states[i]["pos"]
        want = states[i + 1]
        for b, p in enumerate(pos):
            for key in ("k_q", "v_q"):
                diff = mine[key][:, b, :, p].astype(np.int32) \
                    - want[key][:, b, :, p].astype(np.int32)
                assert np.abs(diff).max() <= 1, (label, i, key)
            for key in ("k_s", "v_s"):
                np.testing.assert_allclose(mine[key][:, b, :, p],
                                           want[key][:, b, :, p], rtol=1e-4)


def _one_rank_engine(cfg, seed, prompts, max_new, slots=2, temps=None,
                     faults=(), np_params=None):
    """The one-rank engine's (rid, status, tokens) of each request, sorted,
    and where ``faults`` are given its retries and errors; on the
    reference's parameters where ``np_params`` are given."""
    params = api.init_params(torch.Generator().manual_seed(seed), cfg,
                             "cpu") if np_params is None else \
        params_from_reference(np_params, cfg, "cpu")
    engine = ServeEngine(params, cfg, slots=slots, max_len=32, seed=seed,
                         device="cpu",
                         fault_injector=FaultInjector(list(faults))
                         if faults else None)
    for rid, p in enumerate(prompts):
        engine.submit(Request(rid=rid, prompt=p, max_new_tokens=max_new,
                              temperature=temps[rid] if temps else 0.0))
    want = sorted((r.rid, r.status, list(r.output)) for r in engine.run())
    if not faults:
        assert [len(w[2]) for w in want] == [max_new] * len(prompts)
        return want
    return want, {k: engine.stats[k] for k in ("retries", "errors")}


def _data_engine_key(arch, shape, shard_seq, faulty):
    return (f"{arch}/{'x'.join(map(str, shape))}"
            f"{'/shard_seq' if shard_seq else ''}"
            f"{'/faults' if faulty else ''}")


@functools.cache
def _reference_params(arch):
    """The reference's smoke parameters of ``arch`` from
    ``jax.random.key(0)``, as float32 numpy arrays."""
    return jax.tree.map(lambda a: np.asarray(a, np.float32),
                        r_api.init_params(jax.random.key(0), r_smoke(arch)))


def _data_engine_case(arch, faulty):
    """(cfg, seed, prompts, max_new, slots, temps, faults, np_params) of an
    engine over a data axis: 4 slots, 6 requests (so that slots refill),
    greedy and by temperature, with ``ENGINE_FAULTS`` where ``faulty``;
    an MoE engine on the reference's parameters
    (``REFERENCE_FIRST_TOKENS``), the others on the port's own."""
    cfg = get_smoke_config(arch)
    prompts = [np.random.default_rng(20 + i).integers(0, cfg.vocab, n)
               .astype(np.int32) for i, n in enumerate((5, 9, 3, 7, 4, 6))]
    return (cfg, 0, prompts, 5, 4, ENGINE_TEMPS,
            ENGINE_FAULTS if faulty else (),
            _reference_params(arch) if arch in REFERENCE_FIRST_TOKENS
            else None)


@pytest.mark.parametrize("impl", SEQ_ENGINE_IMPLS)
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_tp_hybrid_engine_with_its_ring_split_equals_one_rank(tp_runs, shape,
                                                              impl):
    """recurrentgemma-2b's engine with its ring split by sequence
    (``shard_seq``: runs of 4 slots at (1, 4), of 8 at (2, 2) with a slot
    a data rank), by the kernel path (``attention_impl`` "cuda", whose
    wrappers take the plain versions on the CPU) and the plain one: 6
    requests on 2 slots, the short prompts spliced into rows whose ring
    was full, give the one-rank engine's greedy tokens on every rank."""
    _, port, _, work, _ = tp_runs
    case = work["seq_engines"][shape][impl]
    want = _one_rank_engine(*case)
    for p in port:
        assert p["seq_engine", shape, impl] == want


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("case", list(WINDOW_SIZES))
@pytest.mark.parametrize("label", list(WINDOW_ARCHS))
def test_tp_windowed_decode_over_a_split_cache_matches_the_reference(
        tp_runs, label, case, shape):
    """``_attention_block(..., window=w)`` in decode mode on each rank's
    run of a cache split by sequence (gemma's, and qwen's int8 cache read
    through ``read_layer``), the ranks' masked partials combined, against
    the reference's ``_attention_block`` with the window on the whole
    cache, on the same numpy inputs, at 1e-4; rows whose window starts
    inside a run, at a run's edge (position 12 or 18) and past whole
    runs."""
    _, port, single, _, _ = tp_runs
    want = single["windows"][label, case]
    for p in port:
        got = next(r for r in p["window", shape]
                   if r["label"] == f"{label}/{case}")
        assert got["run"][0] == shape[1]
        lo, hi = got["rows"]
        np.testing.assert_allclose(got["out"], want[lo:hi], rtol=1e-4,
                                   atol=1e-4, err_msg=f"{label} {case}")


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", MICRO_ARCHS)
def test_tp_train_step_by_microbatches_equals_one_rank(tp_runs, arch, shape):
    """A train step by 2 microbatches over a model axis: the loss and the
    gradient norm of the one-rank step by 2 microbatches, from the same
    carried state at step 60, on every rank."""
    _, port, single, _, _ = tp_runs
    _, one = single["micro", arch]
    for p in port:
        got = next(r for r in p["micro", shape] if r["label"] == arch)
        np.testing.assert_allclose(got["loss"], float(one["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], float(one["grad_norm"]),
                                   rtol=1e-4)
        assert got["step"] == 61


def test_tp_engine_tokens_equal_one_rank_and_every_rank(tp_runs):
    _, port, _, work, _ = tp_runs
    want = _one_rank_engine(*work["engine"])
    for p in port:
        assert p["engine"] == want


def test_tp_moe_engine_tokens_equal_one_rank_and_every_rank(tp_runs):
    """granite's engine over (1, 4), its 4 experts split: the greedy tokens
    of one rank's engine, on every rank."""
    _, port, _, work, _ = tp_runs
    want = _one_rank_engine(*work["moe_engine"])
    for p in port:
        assert p["moe_engine"] == want


@pytest.mark.parametrize("label", list(FAMILIES))
def test_tp_family_engine_tokens_equal_one_rank_and_every_rank(tp_runs,
                                                               label):
    """rwkv6-3b's (a WKV head a rank), recurrentgemma-2b's (its recurrent
    channels split, the ring cache whole) and whisper-medium's (zero frames,
    as the engine makes them) engines over (1, 4): the greedy tokens of one
    rank's engine, on every rank."""
    _, port, _, work, _ = tp_runs
    want = _one_rank_engine(*work["family_engines"][label])
    for p in port:
        assert p["engine", label] == want


@pytest.mark.parametrize("label", MOE_LABELS)
def test_tp_router_gradient_with_aux_equals_one_rank(tp_runs, label):
    """Over (1, 4) the router is whole on every rank and so are its
    probabilities: the gradient of the loss, and of the load-balance loss
    alone, reaches each layer's router as on one rank (not once a rank);
    the gate path's partial gradients are summed over the ranks."""
    from repro_torch.models import moe

    _, port, _, work, _ = tp_runs
    _, cfg, seed, toks = next(c for c in work["router"] if c[0] == label)
    params = api.init_params(torch.Generator().manual_seed(seed), cfg, "cpu")
    routers = [lp.router for lp in params.layers]
    for r in routers:
        r.requires_grad_(True)
    batch = {"tokens": torch.from_numpy(toks)}
    loss = api.train_loss(params, batch, cfg)
    want = torch.autograd.grad(loss, routers)
    _, _, aux = moe.forward(params, batch["tokens"], cfg)
    want_aux = torch.autograd.grad(aux, routers)
    assert float(aux.detach()) > 0
    for p in port:
        got = p["router"][label]
        np.testing.assert_allclose(got["loss"], float(loss.detach()),
                                   rtol=1e-6)
        np.testing.assert_allclose(got["aux"], float(aux.detach()),
                                   rtol=1e-6)
        for i in range(cfg.n_layers):
            _close(got["grad"][i], want[i], f"{label} router {i}")
            _close(got["aux_grad"][i], want_aux[i], f"{label} aux {i}")


@pytest.mark.parametrize("mode", MOE_MODES)
@pytest.mark.parametrize("shape", MOE_MODE_MESHES,
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("label", MOE_LABELS)
def test_moe_mlp_reduces_over_the_batch_ranks_only_in_training(
        tp_runs, label, shape, mode):
    """``moe_mlp`` of one layer with the batch split over the data ranks
    (granite's 4 experts split over "model" at (2, 2), its 5-expert
    variant whole with d_ff split): in ``"train"`` mode its two
    all-reduces over the batch ranks (the expert load and the mean
    probability), so that ``aux`` is the global batch's, the reference's
    GSPMD value at 1e-5; in ``"prefill"`` and ``"decode"`` mode none, and
    ``aux`` the rank's own rows' (one rank's ``moe_mlp`` on them).  Over
    "model" only ``reduce_from_model``'s all-reduce a call; the output is
    the reference's rows in every mode."""
    from repro_torch.models import moe

    ref, port, _, work, _ = tp_runs
    want_out, want_aux = ref["moe_mlp", label, shape]
    cfg, np_params, x = next(c[2:] for c in work["moe_modes"]
                             if c[:2] == (label, shape))
    lp = params_from_reference(np_params, cfg, "cpu").layers[0]
    model = shape[1] > 1
    for p in port:
        got = p["moe_mlp", label, shape, mode]
        rows = slice(*got["rows"])
        over = collections.Counter(axis for _, axis, _, _ in got["records"])
        want = {"data": 2 if mode == "train" else 0, "model": int(model)}
        assert dict(over) == {k: n for k, n in want.items() if n}, \
            got["records"]
        np.testing.assert_allclose(got["out"], want_out[rows], rtol=1e-4,
                                   atol=1e-6)
        if mode == "train":
            np.testing.assert_allclose(got["aux"], want_aux, rtol=1e-5)
        else:
            _, aux = moe.moe_mlp(lp, torch.from_numpy(x[rows]), cfg, None)
            np.testing.assert_allclose(got["aux"], float(aux), rtol=1e-6)


@pytest.mark.parametrize("faulty", [False, True], ids=["clean", "faults"])
@pytest.mark.parametrize("shape,shard_seq", DATA_ENGINE_MESHES,
                         ids=["2x2", "4x1", "2x2-shard_seq"])
@pytest.mark.parametrize("arch", DATA_ENGINE_ARCHS)
def test_tp_engine_over_a_data_axis_equals_one_rank(tp_runs, arch, shape,
                                                    shard_seq, faulty):
    """The engine with its 4 slots split over the data ranks (2 a rank on
    (2, 2), 1 on (4, 1); the cache also split by sequence over "model"
    under ``shard_seq`` where its spec leaves the sequence to the axis):
    6 requests, greedy and by temperature, give the one-rank engine's
    tokens and statuses on every rank; with faults injected (a prefill
    that fails past its retries, one retried, a decode step retried) also
    its retries and errors.  The MoE engines' prefills run on the owner's
    model group alone, so their routed MLPs reduce nothing over the data
    axis there (``moe_mlp`` in ``"prefill"`` and ``"decode"`` mode)."""
    _, port, _, work, _ = tp_runs
    key = _data_engine_key(arch, shape, shard_seq, faulty)
    case = next(c[3] for c in work["data_engines"] if c[0] == key)
    want = _one_rank_engine(*case)
    if faulty:
        statuses = {rid: status for rid, status, _ in want[0]}
        assert statuses[2] == "error"
        # request 2's every retry, request 4's one, the decode step's one
        assert want[1] == {"retries": RecoveryPolicy().max_attempts + 2,
                           "errors": 1}
    for p in port:
        assert p["data_engine", key] == want


@pytest.mark.parametrize("faulty", [False, True], ids=["clean", "faults"])
@pytest.mark.parametrize("shape,shard_seq", DATA_ENGINE_MESHES,
                         ids=["2x2", "4x1", "2x2-shard_seq"])
@pytest.mark.parametrize("arch", list(REFERENCE_FIRST_TOKENS))
def test_tp_moe_engine_over_a_data_axis_gives_the_reference_tokens(
        tp_runs, arch, shape, shard_seq, faulty):
    """granite-moe-1b's and granite-moe-3b's engines over a data axis, on
    the reference's parameters: request 0 (greedy, never faulted) gives
    on every rank the tokens of the reference's engine on the same
    prompts."""
    _, port, _, _, _ = tp_runs
    key = _data_engine_key(arch, shape, shard_seq, faulty)
    for p in port:
        got = p["data_engine", key]
        rid, status, tokens = (got[0] if faulty else got)[0]
        assert (rid, status) == (0, "ok")
        assert tokens == REFERENCE_FIRST_TOKENS[arch]


@pytest.mark.parametrize("shape,shard_seq", DATA_FAMILY_MESHES,
                         ids=["2x2", "4x1"])
@pytest.mark.parametrize("arch", DATA_FAMILY_ARCHS)
def test_tp_family_engine_over_a_data_axis_equals_one_rank(tp_runs, arch,
                                                           shape, shard_seq):
    """The other families' engines (RWKV-6, the hybrid, the
    encoder-decoder, the int8 cache with QKV biases, the VLM's patch
    prefix, LayerNorm at head dim 80) with their 4 slots split over the
    data ranks: 6 requests, greedy and by temperature, give the one-rank
    engine's tokens and statuses on every rank."""
    _, port, _, work, _ = tp_runs
    key = _data_engine_key(arch, shape, shard_seq, False)
    case = next(c[3] for c in work["data_engines"] if c[0] == key)
    want = _one_rank_engine(*case)
    for p in port:
        assert p["data_engine", key] == want


def test_tp_engine_refuses_a_data_axis_and_other_families():
    """An engine refuses slots that its data ranks do not split evenly;
    over a model axis every family builds one, its decode state the
    rank's part: rwkv6-3b's WKV state one of 4 heads, recurrentgemma-2b's
    recurrent state a quarter of its channels (the ring cache of its one
    KV head whole, or under ``shard_seq`` a run of 4 of its 16 slots),
    whisper-medium's caches one of 4 KV heads."""
    cfg = get_smoke_config("phi3-mini-3.8b")
    params = api.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    mesh = {"data": 2, "model": 2}
    rules = rules_for(cfg, mesh, "tp").with_mesh(mesh)
    with pytest.raises(ValueError, match="3 slots do not split over 2"):
        ServeEngine(params, cfg, slots=3, rules=rules, device="cpu")
    mesh = {"data": 1, "model": 4}
    cfg = get_smoke_config("recurrentgemma-2b")
    rules = rules_for(cfg, mesh, "tp", shard_seq=True).with_mesh(mesh)
    assert api.state_specs(cfg, rules)["attn_k"][3] == "model"
    engine = ServeEngine(None, cfg, slots=2, max_len=32, rules=rules,
                         device="cpu")
    assert tuple(engine.state["attn_k"].shape) == (2, 2, 1, 4, 16)
    assert tuple(engine.state["slot_pos"].shape) == (2, 2, 4)
    shapes = {"rwkv6-3b": {"wkv": (2, 2, 1, 16, 16)},
              "recurrentgemma-2b": {"attn_k": (2, 2, 1, 16, 16)},
              "whisper-medium": {"self_k": (2, 2, 1, 32, 16),
                                 "cross_k": (2, 2, 1, 16, 16)}}
    for arch, want in shapes.items():
        cfg = get_smoke_config(arch)
        rules = rules_for(cfg, mesh, "tp").with_mesh(mesh)
        engine = ServeEngine(None, cfg, slots=2, max_len=32, rules=rules,
                             device="cpu")
        for name, shape in want.items():
            assert tuple(engine.state[name].shape) == shape, (arch, name)
        if arch == "recurrentgemma-2b":
            assert engine.state["rec1"]["h"].shape[-1] == cfg.d_model // 4
            assert engine.state["tail"][0]["conv"].shape[-1] == \
                cfg.d_model // 4


def _elastic_state(cfg=None):
    cfg = cfg or dataclasses.replace(get_smoke_config("phi3-mini-3.8b"),
                                     attention_impl="xla")
    state = init_train_state(torch.Generator().manual_seed(0), cfg, "cpu")
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in state.params.parameters():
            p.add_(torch.randn(p.shape, generator=g))
    for name, m in state.opt.master.items():
        m.add_(torch.randn(m.shape, generator=g))
        state.opt.mu[name].copy_(torch.randn(m.shape, generator=g))
        state.opt.nu[name].copy_(torch.rand(m.shape, generator=g))
    state.opt.step.fill_(3)
    return cfg, state


@pytest.mark.parametrize("onto", [(1, 4), (4, 1)],
                         ids=lambda s: "x".join(map(str, s)))
def test_tp_state_saved_on_2x2_restores_bit_for_bit(tp_runs, onto):
    """The counterpart of ``tests/test_multidevice.py::
    test_elastic_reshard_across_meshes``: saved on (2, 2) with the params
    split over "model" and the optimizer state over both axes, restored
    onto another mesh, each rank's slices equal to those of the whole
    state."""
    _, port, _, work, _ = tp_runs
    state, cfg = work["elastic"][0], work["elastic"][1]
    whole = dict(state.params.named_parameters())
    for p in port:
        el = p["elastic"]
        assert el["saved_shapes"]["layers.0.wq"] == (cfg.d_model,
                                                     cfg.q_dim // 2)
        got = el[onto]
        assert got["equal"] and got["step"] == 3 and got["opt_step"] == 3
        assert got["shapes"]["embed"] == (cfg.vocab // onto[1], cfg.d_model)
        assert got["shapes"]["layers.0.attn_norm.scale"] == \
            tuple(whole["layers.0.attn_norm.scale"].shape)


@pytest.mark.parametrize("onto", [(1, 4), (4, 1)],
                         ids=lambda s: "x".join(map(str, s)))
def test_tp_moe_state_saved_on_2x2_restores_bit_for_bit(tp_runs, onto):
    """granite's state saved on (2, 2), its 4 experts split 2 ways over
    "model", restored onto (1, 4) (4 ways) and (4, 1) (whole), each rank's
    slices equal to those of the whole state; and onto one rank."""
    _, port, _, work, _ = tp_runs
    state, cfg, directory = work["moe_elastic"]
    for p in port:
        el = p["moe_elastic"]
        assert el["saved_shapes"]["layers.0.moe.w_up"] == (
            cfg.n_experts // 2, cfg.d_model, cfg.d_ff)
        got = el[onto]
        assert got["equal"] and got["step"] == 3 and got["opt_step"] == 3
        assert got["shapes"]["layers.0.moe.w_down"] == (
            cfg.n_experts // onto[1], cfg.d_ff, cfg.d_model)
        assert got["shapes"]["layers.0.router"] == (cfg.d_model,
                                                    cfg.n_experts)
    specs = train_state_specs(cfg, rules_for(cfg, {"data": 1, "model": 1},
                                             "tp"))
    template = init_train_state(torch.Generator().manual_seed(5), cfg, "cpu")
    one, meta = restore_resharded(CheckpointManager(directory), template,
                                  specs, None)
    assert meta["step"] == 3
    for a, b in zip(_leaves(state), _leaves(one)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("onto", [(1, 4), (4, 1)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("label", list(FAMILIES))
def test_tp_family_state_saved_on_2x2_restores_bit_for_bit(tp_runs, label,
                                                           onto):
    """rwkv6-3b's, recurrentgemma-2b's and whisper-medium's states saved on
    (2, 2) restored onto (1, 4) and (4, 1), each rank's slices equal to
    those of the whole state (the hybrid's ``w_in`` by blocks: each rank's
    part of z and of y)."""
    _, port, _, work, _ = tp_runs
    state, cfg, _ = work["family_elastic"][label]
    whole = dict(state.params.named_parameters())
    for p in port:
        el = p["elastic", label]
        got = el[onto]
        assert got["equal"] and got["step"] == 3 and got["opt_step"] == 3
        for name, shape in got["shapes"].items():
            if name.endswith("w_in"):
                assert shape == (cfg.d_model, 2 * cfg.d_model // onto[1])
            assert len(shape) == whole[name].ndim


@pytest.mark.parametrize("label", list(FAMILIES))
def test_tp_family_state_saved_on_2x2_restores_onto_one_rank(tp_runs, label):
    """The whole leaves a sharded save wrote, read back on one rank, are
    the state's own bit for bit (the hybrid's ``w_in`` as [z | y], the
    reference's layout)."""
    _, _, _, work, _ = tp_runs
    state, cfg, directory = work["family_elastic"][label]
    specs = train_state_specs(cfg, rules_for(cfg, {"data": 1, "model": 1},
                                             "tp"))
    template = init_train_state(torch.Generator().manual_seed(5), cfg, "cpu")
    one, meta = restore_resharded(CheckpointManager(directory), template,
                                  specs, None)
    assert meta["step"] == 3
    for a, b in zip(_leaves(state), _leaves(one)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_tp_state_saved_on_2x2_restores_onto_one_rank(tp_runs):
    _, _, _, work, directory = tp_runs
    state, cfg = work["elastic"][0], work["elastic"][1]
    specs = train_state_specs(cfg, rules_for(cfg, {"data": 1, "model": 1},
                                             "tp"))
    template = init_train_state(torch.Generator().manual_seed(5), cfg, "cpu")
    one, meta = restore_resharded(CheckpointManager(directory), template,
                                  specs, None)
    assert meta["step"] == 3
    for a, b in zip(_leaves(state), _leaves(one)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _leaves(state):
    opt = state.opt
    return [p.detach() for p in state.params.parameters()] + [opt.step] + [
        t for tree in (opt.master, opt.mu, opt.nu) for t in tree.values()]


# -- the autograd operators ---------------------------------------------------


def _slice_cols(a, r, m=N):
    n = a.shape[-1] // m
    return a[..., r * n:(r + 1) * n]


def test_copy_and_reduce_from_model_match_one_rank_autograd(tp_runs):
    _, port, _, work, _ = tp_runs
    inp = {k: torch.from_numpy(v) for k, v in work["ops"].items()}
    x = inp["x"].clone().requires_grad_()
    y = x @ inp["w"]
    (y * inp["g"]).sum().backward()
    xr = inp["x"].clone().requires_grad_()
    z = xr @ inp["w"]
    (z * inp["g"]).sum().backward()
    for p in port:
        r = p["ops"]["rank"]
        got_y, got_dx = p["ops"]["copy"]
        np.testing.assert_allclose(got_y, _np(_slice_cols(y, r)), rtol=1e-5,
                                   atol=1e-5)
        # the gradient of an input every rank uses: summed over the ranks,
        # once (psum_grad's psum backward would give it 4 times over)
        np.testing.assert_allclose(got_dx, _np(x.grad), rtol=1e-5, atol=1e-5)
        got_z, got_dxr = p["ops"]["reduce"]
        np.testing.assert_allclose(got_z, _np(z), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got_dxr, _np(_slice_cols(xr.grad, r)),
                                   rtol=1e-5, atol=1e-5)


def test_gather_from_model_backward_is_a_reduce_scatter(tp_runs):
    _, port, _, work, _ = tp_runs
    inp = {k: torch.from_numpy(v) for k, v in work["ops"].items()}
    w = inp["w"].clone().requires_grad_()
    k = inp["x"] @ w
    (k * inp["gk"].sum(0)).sum().backward()
    for p in port:
        r = p["ops"]["rank"]
        got_k, got_dw = p["ops"]["gather"]
        np.testing.assert_allclose(got_k, _np(k), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got_dw, _np(_slice_cols(w.grad, r)),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("z_loss", [0.0, 1e-3])
def test_vocab_parallel_xent_matches_one_rank_autograd(tp_runs, z_loss):
    _, port, _, work, _ = tp_runs
    inp = {k: torch.from_numpy(v) for k, v in work["ops"].items()}
    lg = inp["logits"].clone().requires_grad_()
    lse = torch.logsumexp(lg, -1)
    loss = lse - lg.gather(-1, inp["labels"][:, None])[:, 0]
    if z_loss:
        loss = loss + z_loss * lse ** 2
    (loss * inp["w_tok"]).sum().backward()
    np.testing.assert_allclose(
        float(softmax_xent(inp["logits"], inp["labels"], z_loss)),
        float(loss.detach().mean()), rtol=1e-6)
    for p in port:
        r = p["ops"]["rank"]
        got, grad = p["ops"][f"xent/{z_loss}"]
        np.testing.assert_allclose(got, _np(loss), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(grad, _np(_slice_cols(lg.grad, r)),
                                   rtol=1e-5, atol=1e-6)


def test_vocab_parallel_embed_matches_a_lookup(tp_runs):
    _, port, _, work, _ = tp_runs
    inp = {k: torch.from_numpy(v) for k, v in work["ops"].items()}
    table = inp["table"].clone().requires_grad_()
    rows = table[inp["labels"]]
    (rows * inp["g_embed"]).sum().backward()
    vl = table.shape[0] // N
    for p in port:
        r = p["ops"]["rank"]
        got, grad = p["ops"]["embed"]
        assert np.array_equal(got, _np(rows))  # one rank's row plus zeros
        np.testing.assert_allclose(grad, _np(table.grad[r * vl:(r + 1) * vl]),
                                   rtol=1e-6, atol=1e-6)


def test_tp_reaches_the_dense_and_vlm_families_and_slices_carried_params():
    """``make_train_step`` accepts a model axis of more than one rank for
    every family, ``param_shapes`` builds the whole module on the meta
    device, and reference params carried onto a rank are its slices of
    them."""
    for arch in ("gemma-2b", "internvl2-26b", *FAMILIES):
        cfg = dataclasses.replace(get_smoke_config(arch),
                                  attention_impl="xla")
        mesh = {"data": 2, "model": 2}
        rules = rules_for(cfg, mesh, "tp")
        assert rules.spec(("heads",)) == ("model",)
        make_train_step(cfg, rules, mesh)
    cfg = dataclasses.replace(get_smoke_config("internvl2-26b"),
                              attention_impl="xla")
    shapes = api.param_shapes(cfg)
    assert shapes.embed.shape == (cfg.vocab, cfg.d_model)
    assert shapes.embed.device.type == "meta"
    assert [n for n, _ in shapes.named_parameters()] == [
        n for n, _ in api.init_params(torch.Generator(), cfg,
                                      "cpu").named_parameters()]

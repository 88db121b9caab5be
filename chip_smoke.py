#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

builds the CUDA kernels from ``src/repro_torch/csrc``, holds each against
its plain PyTorch version on the card, and drives the port's paths —
annotated-kernel launches through ``Context.launch`` (the 1-D stencil,
HotSpot, K-Means, co-clustering sums, GEMM, and the paper's section 4.2
benchmarks Black-Scholes, SpMV, MD5, N-Body and the correlator) and
host-memory streaming through ``stream_kmeans``, at sizes a user of the
paper's benchmarks would call real (the launch phase's mesh pass runs five
of those applications again over 4 workers of one ``Context`` on the one
card, each held against 1 worker); then LM serving through
``ServeEngine`` at full width and depth in bf16 (random weights from
``--seed``) with one model of each family the port serves: phi3-mini-3.8b
(the flash- and decode-attention kernels), rwkv6-3b (the WKV6 kernel),
recurrentgemma-2b (the RG-LRU kernel, and flash attention in a prefill's
local attention), granite-moe-3b-a800m (flash and decode attention at a
GQA group of 3, beside top-8 routing over 40 experts; its plain passes
replay the kernel passes' expert choices) and whisper-medium (flash
attention non-causal over 1500 encoder frames and in the decoder, decode
attention against the self- and cross-attention caches); then training
with gemma-2b at full width and depth in bf16 (``attention_impl="xla"``:
the kernels are forward-only), ten steps of 8 x 512 tokens from the token
stream with remat, after one step held against the CPU in f32 at two
layers, two microbatches against one, the kernels' gradient guard, and
``run_training`` with an injected failure and a bit-exact resume; then the
distribution layer over ranks: 4 processes on the one card under gloo
(which stages a card tensor through the host) run the collectives against
one process, flash-decode over a cache split in 4 (the decode-attention
kernel on each rank's shard, the partials combined over the ranks),
gemma-2b's data-parallel step at full width and 2 layers (ZeRO-1 against
one rank in f32; ZeRO-1 and replicated in bf16) and the restore of its
ZeRO-1 checkpoint onto 2 ranks and 1, and one rank runs the NCCL path;
then tensor parallelism over a ``"model"`` axis of 4 ranks on the card:
phi3-mini-3.8b and granite-moe-3b-a800m (its 40 experts 10 a rank) served
at full width and depth on each rank's heads, gemma-2b and
granite-moe-1b-a400m trained at full width and depth, with their f32
checks against one rank and a checkpoint restored across meshes; then the
dry run on the meta device (every cell of one pod of 256 ranks under
``tp`` and ``dp``), its bytes and collectives held exactly against what
the ``tp`` phase measured and its roofline beside the ``train`` phase's
step.  Phases (each prints one JSON line with the seconds it took):
``env``, ``build``, ``kernels``, ``launch``, ``stream``, ``sim``,
``serve`` once for each model, ``train``, ``dist``, ``tp`` and
``dryrun``.  The ``sim`` phase measures the card's
copy rates, its FP32 rate (the f32 GEMM) and its memory beside the
simulator's ``HardwareModel()`` constants, which they must match within
``SIM_RATE_RANGE``, and sets the port's ``Simulator``'s prediction for the
stream phase's workload beside what that phase measured.  GEMM, flash
attention, decode attention, the correlator, WKV6, RG-LRU, K-Means, SpMV,
MD5 and N-Body have more than one route (``"wgmma"``: the tensor cores fed
by TMA; ``"mma"``: decode attention's query heads on the tensor cores by
``mma.sync``, fed by ``cp.async``; ``"pipe"``: the f32 GEMM on the CUDA
cores with its loads one stage ahead; ``"tri"``: the correlator's tiles
with i <= j, the rest mirrored; ``"chunk"``: WKV6 and RG-LRU as scans over
chunks of time; ``"private"``: K-Means with several points a thread and
accumulators private to a thread; ``"bin"``: SpMV's entries binned by
column slice so that its gathers hit L2; ``"unwind"``: MD5 with the
target's last eight rounds undone on the host; ``"tile"``: N-Body with two
targets a thread over slices of the sources and an unguarded rsqrt;
``"fma"``: the first
kernels, on the CUDA cores): the run
requires the redesigned route for the main-path calls, the tensor cores'
instructions (``HGMMA``, ``HMMA``) in those routes' kernels only, no
register spills in them, and times their first version
(``"fma"``) beside them.  Any
exception or any comparison outside its tolerance ends the run with a
non-zero exit code.  The last three
lines of the output are the kernel table, the card's name and power limit,
and the verdict.

It needs a CUDA device and fails without one.  ``--rehearse`` runs the same
control flow at toy sizes on the CPU with the plain versions, to find wrong
paths and shapes where there is no card; it measures nothing and its last
line says ``"ok": false``.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import gc
import io
import itertools
import json
import multiprocessing
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
import warnings
from typing import Callable
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.core import (  # noqa: E402
    ArrayMeta,
    BlockDist,
    BlockWork,
    Context,
    HardwareModel,
    KernelDef,
    Planner,
    ReplicatedDist,
    RowDist,
    Simulator,
    StencilDist,
    Topology,
    parse,
)
from repro_torch.ckpt import (  # noqa: E402
    CheckpointManager,
    restore_resharded,
)
from repro_torch.configs import (  # noqa: E402
    ARCHS,
    get_config,
    get_smoke_config,
)
from repro_torch.configs.shapes import SHAPE_NAMES, ShapeSpec  # noqa: E402
from repro_torch.core.mesh import (  # noqa: E402
    is_rank_mesh,
    local_worker,
    shard_of,
)
from repro_torch.core.streaming import stream_kmeans  # noqa: E402
from repro_torch.data import DataConfig, TokenStream  # noqa: E402
from repro_torch.dist import (  # noqa: E402
    hierarchical_grad_allreduce,
    ranks,
    ring_allgather_matmul,
    ring_allreduce,
    set_tracer,
)
from repro_torch.kernels import (  # noqa: E402
    _build,
    attention_ref,
    black_scholes,
    black_scholes_ref,
    cluster_sums,
    cluster_sums_ref,
    correlate,
    correlate_ref,
    decode_attention,
    decode_attention_ref,
    flash_attention,
    gemm,
    gemm_ref,
    hotspot_step,
    hotspot_step_ref,
    kmeans_assign_reduce,
    kmeans_assign_reduce_ref,
    md5_search,
    md5_search_ref,
    md5_u32x2,
    nbody_forces,
    nbody_forces_ref,
    rg_lru,
    spmv_ell,
    spmv_ell_ref,
    wkv6,
    wkv6_ref,
)
from repro_torch.kernels.black_scholes.kernel import (  # noqa: E402
    black_scholes_cuda,
)
from repro_torch.kernels.common import (  # noqa: E402
    H100_SXM_BF16_FLOPS,
    H100_SXM_FP32_FLOPS,
    H100_SXM_HBM_BYTES_PER_S,
    H100_SXM_INT32_ALU_OPS,
    H100_SXM_INT32_OPS,
)
from repro_torch.kernels.coclustering.kernel import (  # noqa: E402
    cluster_sums_cuda,
)
from repro_torch.kernels.correlator.kernel import (  # noqa: E402
    TILE as CORR_TILE,
    correlate_cuda,
    correlate_route,
)
from repro_torch.kernels.decode_attention.kernel import (  # noqa: E402
    decode_attention_cuda,
)
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention_cuda,
)
from repro_torch.kernels.gemm.kernel import gemm_cuda  # noqa: E402
from repro_torch.kernels.kmeans.kernel import kmeans_cuda  # noqa: E402
from repro_torch.kernels.md5.kernel import (  # noqa: E402
    md5_search_cuda,
    md5_unwound_search_cuda,
)
from repro_torch.kernels.md5.ref import (  # noqa: E402
    KEY_XOR,
    UNWIND_TEST_ROUNDS,
    md5_final_state,
    md5_message,
    md5_unround,
    md5_unwind,
    md5_word1_target,
    word_index,
)
from repro_torch.kernels.nbody.kernel import (  # noqa: E402
    TILE as NBODY_TILE,
    TILE_SLICES as NBODY_TILE_SLICES,
    nbody_cuda,
)
from repro_torch.kernels.nbody.ref import (  # noqa: E402
    SOFTENING2,
    nbody_slices,
)
from repro_torch.kernels.rg_lru.kernel import (  # noqa: E402
    CHUNK_LEN as LRU_CHUNK_LEN,
    rg_lru_cuda,
    rg_lru_route,
)
from repro_torch.kernels.rg_lru.ref import (  # noqa: E402
    rg_lru_chunk_carry,
    rg_lru_chunk_local,
    rg_lru_chunk_outputs,
    rg_lru_scan,
)
from repro_torch.kernels.rwkv6.kernel import (  # noqa: E402
    CHUNK_LEN,
    wkv6_cuda,
    wkv6_route,
)
from repro_torch.kernels.rwkv6.ref import (  # noqa: E402
    wkv6_chunk_carry,
    wkv6_chunk_outputs,
    wkv6_chunk_updates,
)
from repro_torch.kernels.spmv_ell.kernel import spmv_ell_cuda  # noqa: E402
from repro_torch.kernels.spmv_ell.ref import (  # noqa: E402
    bin_entries,
    bin_layout,
    gather_bins,
)
from repro_torch.kernels.stencil2d.kernel import hotspot_cuda  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    make_mesh,
    make_production_mesh,
)
from repro_torch.launch.rules import rules_for  # noqa: E402
from repro_torch.launch.train import run_training  # noqa: E402
from repro_torch.models import api as model_api  # noqa: E402
from repro_torch.models import attention as model_attention  # noqa: E402
from repro_torch.models import kvcache  # noqa: E402
from repro_torch.models import moe as model_moe  # noqa: E402
from repro_torch.models import rglru as model_rglru  # noqa: E402
from repro_torch.models import rwkv as model_rwkv  # noqa: E402
from repro_torch.models.layers import causal_lm_loss, rms_norm  # noqa: E402
from repro_torch.obs import (  # noqa: E402
    analyze,
    validate_chrome_trace,
)
from repro_torch.obs.trace import Tracer  # noqa: E402
from repro_torch.optim import (  # noqa: E402
    AdamWState,
    adamw_update,
    compressed_psum,
)
from repro_torch.serve.engine import (  # noqa: E402
    Request,
    ServeEngine,
    _splice_state,
)
from repro_torch.utils.roofline import (  # noqa: E402
    PEAK_FLOPS as ROOFLINE_PEAK_FLOPS,
)
from repro_torch.train.train_loop import (  # noqa: E402
    TrainState,
    init_train_state,
    local_train_state,
    make_train_step,
    train_state_specs,
)

#: the wrappers whose ``launches`` counters prove the path went through the
#: hand-written kernels
WRAPPERS = {
    "kmeans": kmeans_cuda,
    "hotspot": hotspot_cuda,
    "cluster_sums": cluster_sums_cuda,
    "gemm": gemm_cuda,
    "black_scholes": black_scholes_cuda,
    "spmv_ell": spmv_ell_cuda,
    "md5": md5_search_cuda,
    "nbody": nbody_cuda,
    "flash_attention": flash_attention_cuda,
    "decode_attention": decode_attention_cuda,
    "correlate": correlate_cuda,
    "wkv6": wkv6_cuda,
    "rg_lru": rg_lru_cuda,
}


def zero_counts() -> None:
    """Every wrapper's launch count, and its counts by route, to 0."""
    for wrapper in WRAPPERS.values():
        wrapper.launches = 0
        for route in getattr(wrapper, "routes", {}):
            wrapper.routes[route] = 0


def route_counts() -> dict:
    """The launches of each two-route wrapper by route."""
    return {name: dict(w.routes) for name, w in WRAPPERS.items()
            if hasattr(w, "routes")}


@dataclasses.dataclass(frozen=True)
class Sizes:
    stencil_n: int = 1 << 24
    hotspot: tuple = (8192, 8192)
    hotspot_steps: int = 20
    kmeans_n: int = 1 << 26
    kmeans_iters: int = 5
    csums: tuple = (16384, 8192)
    gemm: int = 8192
    stream_n: int = 1 << 28
    stream_chunk_rows: int = 1 << 22
    stream_iters: int = 2
    # the paper's section 4.2 benchmarks (BS and SpMV also section 4.3)
    bs_n: int = 1 << 29  # options: 10 GiB of inputs and outputs
    spmv: tuple = (1 << 25, 16)  # rows = len(x), max_nnz
    # a shape SpMV's route "bin" takes, ragged in rows and n: rows,
    # max_nnz, n
    spmv_bin_ragged: tuple = (3 * (1 << 20) + 37, 8, (1 << 24) + 5)
    md5_n: int = 1 << 30  # keys
    nbody_n: int = 1 << 17  # bodies
    nbody_slab: int = 1024  # targets held against the float64 version
    # attention kernels: (B, HQ, HKV, S, D) and (B, HQ, HKV, T, D), the
    # serving path's (phi3-mini-3.8b: prefill of 2048 tokens; 8 slots of a
    # 2184-position cache) and gemma-2b's MQA (group 8, head_dim 256)
    flash: tuple = (1, 32, 32, 2048, 96)
    flash_gemma: tuple = (1, 8, 1, 1000, 256)
    decode: tuple = (8, 32, 32, 2184, 96)
    decode_gemma: tuple = (8, 8, 1, 2184, 256)
    # recurrentgemma-2b's ring-buffer decode: 8 slots, 10 query heads on
    # one kv head of 256, a window of 2048
    decode_rgemma: tuple = (8, 10, 1, 2048, 256)
    # granite-moe-3b's prefill of 2048 tokens and 8-slot decode (24 query
    # heads on 8 kv heads of 64: a group of 3); whisper-medium's encoder
    # (1500 frames, non-causal), its decoder's cross-attention of a
    # 320-token prompt against the 1500 frames (non-causal), and its
    # decode step's cross-attention (8 slots, kv_len 1500); 16 heads of 64
    flash_granite: tuple = (1, 24, 8, 2048, 64)
    flash_whisper_encoder: tuple = (1, 16, 16, 1500, 64)
    flash_whisper_cross: tuple = (1, 16, 16, 320, 64)
    whisper_frames: int = 1500
    decode_granite: tuple = (8, 24, 8, 2184, 64)
    decode_whisper_cross: tuple = (8, 16, 16, 1500, 64)
    # the correlator: (C, T, A) channels, samples, antennas (1.61 GB f32)
    corr: tuple = (1024, 768, 256)
    # the recurrent scans at the serving path's shapes: rwkv6-3b's prefill
    # of 2048 tokens and 8-slot decode step, (B, H, T, K = V); and
    # recurrentgemma-2b's, (B, T, D)
    wkv: tuple = (1, 40, 2048, 64)
    wkv_decode: tuple = (8, 40, 1, 64)
    lru: tuple = (1, 2048, 2560)
    lru_decode: tuple = (8, 1, 2560)
    # the LM serving path
    serve_smoke: bool = False  # the full configs, not their smoke ones
    serve_requests: int = 24
    serve_requests_recurrent: int = 24  # rwkv6-3b's and recurrentgemma-2b's
    serve_slots: int = 8
    serve_prompt: tuple = (128, 2048)  # prompt lengths, heavy-tailed
    serve_new: tuple = (32, 128)  # max_new_tokens, uniform
    serve_check_len: int = 2048  # prompt of the prefill check
    serve_check_len_window: int = 2600  # the hybrid's: past its window
    # whisper-medium's traffic, inside its decoder's published context of
    # 448 tokens: prompts heavy-tailed over 16-320 tokens, the check prompt
    # at the longest
    serve_prompt_whisper: tuple = (16, 320)
    serve_max_len_whisper: int = 448
    profile_steps: int = 3
    # the training path: gemma-2b at full width and depth (its smoke
    # config in a rehearsal), a global batch of train_batch x train_seq
    # tokens from the token stream, train_steps steps; the card-against-CPU
    # and microbatch checks at full width and train_check_layers layers,
    # the former on train_check_batch
    train_smoke: bool = False
    train_batch: int = 8
    train_seq: int = 512
    train_steps: int = 10
    train_check_layers: int = 2
    train_check_batch: tuple = (2, 128)
    # the distribution layer: 4 ranks on the one card (gloo), collectives
    # of dist_elems f32 a rank (the rotate ring's leading dim one more,
    # which 4 does not divide), the ring collective matmul's (M, K, N),
    # flash-decode over 4 shards of dist_decode's cache (phi3-mini's decode
    # shape), and gemma-2b's data-parallel step at dist_train_layers
    # layers on train_batch x train_seq tokens, timed over dist_train_steps
    dist_ranks: int = 4
    dist_elems: int = 1 << 24
    dist_matmul: tuple = (4096, 8192, 4096)
    dist_decode: tuple = (8, 32, 32, 2184, 96)
    dist_train_layers: int = 2
    dist_train_steps: int = 3
    # tensor parallelism over a (1, 4) ("data", "model") mesh of 4 ranks on
    # the one card: phi3-mini served at full width and depth (8 query and 8
    # KV heads a rank: a prefill of tp_check_len tokens at tp_flash, the
    # 8-slot decode at tp_decode) by tp_requests requests of tp_prompt
    # tokens and tp_new new ones, its f32 logits at tp_f32_layers layers
    # over tp_f32_steps decode steps against one rank's; gemma-2b trained
    # at full width and depth, tp_train_steps steps of tp_train_batch
    # tokens, and its checks at dist_train_layers layers
    tp_ranks: int = 4
    tp_flash: tuple = (1, 8, 8, 1024, 96)
    tp_decode: tuple = (8, 8, 8, 2184, 96)
    tp_requests: int = 8
    tp_prompt: tuple = (128, 1024)
    tp_new: int = 32
    tp_max_len: int = 2184
    tp_check_len: int = 1024
    tp_f32_layers: int = 2
    tp_f32_steps: int = 4
    tp_train_batch: tuple = (4, 512)
    tp_train_steps: int = 3
    # granite-moe-3b-a800m's rank shapes over the same (1, 4) mesh (6 of
    # 24 query heads and 2 of 8 KV heads a rank): the check prefill and
    # the 8-slot decode
    tp_flash_granite: tuple = (1, 6, 2, 1024, 64)
    tp_decode_granite: tuple = (8, 6, 2, 2184, 64)
    # rwkv6-3b's, recurrentgemma-2b's and whisper-medium's rank shapes over
    # the same mesh: 10 of 40 WKV heads a rank (a prefill of 2048 tokens
    # by route "chunk", the 8-slot decode step by "fma"); 640 of the 2560
    # RG-LRU channels; whisper's 4 of 16 heads of 64: its encoder over
    # 1500 frames and a decoder prefill of 320 tokens, self (causal) and
    # cross (against the frames), and its 8-slot decode step, self (kv_len
    # up to 448) and cross (kv_len 1500)
    tp_wkv: tuple = (1, 10, 2048, 64)
    tp_wkv_decode: tuple = (8, 10, 1, 64)
    tp_lru: tuple = (1, 2048, 640)
    tp_lru_decode: tuple = (8, 1, 640)
    tp_flash_whisper_encoder: tuple = (1, 4, 4, 1500, 64)
    tp_flash_whisper_self: tuple = (1, 4, 4, 320, 64)
    tp_decode_whisper_self: tuple = (8, 4, 4, 448, 64)
    tp_decode_whisper_cross: tuple = (8, 4, 4, 1500, 64)
    # the engines of the families added to the tp phase last (rwkv6-3b,
    # recurrentgemma-2b, whisper-medium) serve tp_requests_added requests
    # of tp_new_added new tokens; the recurrent families' train steps over
    # (1, 4) run the plain step loops (the kernels are forward-only), a
    # Python step a token and layer, on a global batch of
    # tp_train_batch_recurrent tokens
    tp_requests_added: int = 4
    tp_new_added: int = 8
    tp_train_batch_recurrent: tuple = (4, 128)
    # the cells over other meshes (TP_SEQ_CELLS) serve the tp traffic above
    # on tp_seq_slots slots, which the data ranks split; a gemma-2b rank's
    # decode over its run of the cache split by sequence (8 query heads
    # gathered, one KV head of 256, 2184 / 4 positions)
    tp_seq_slots: int = 8
    tp_decode_gemma_seq: tuple = (8, 8, 1, 546, 256)
    # the dry run on the meta device: every cell of one pod under "tp" and
    # "dp" (dryrun_archs None: every arch), over a process a core
    dryrun_archs: tuple | None = None
    reps: int = 5


FULL = Sizes()
TOY = Sizes(stencil_n=1 << 12, hotspot=(96, 160), hotspot_steps=3,
            kmeans_n=1 << 12, kmeans_iters=2, csums=(192, 320), gemm=96,
            stream_n=(1 << 13) + 100, stream_chunk_rows=1 << 11,
            stream_iters=2, bs_n=(1 << 12) + 3, spmv=((1 << 10) + 8, 16),
            spmv_bin_ragged=((1 << 12) + 37, 8, (1 << 12) + 5),
            md5_n=1 << 13, nbody_n=1000, nbody_slab=256,
            flash=(1, 4, 4, 64, 32), flash_gemma=(1, 4, 1, 40, 64),
            decode=(3, 4, 4, 70, 32), decode_gemma=(3, 4, 1, 70, 64),
            decode_rgemma=(3, 5, 1, 70, 64),
            flash_granite=(1, 6, 2, 64, 32),
            flash_whisper_encoder=(1, 4, 4, 60, 32),
            flash_whisper_cross=(1, 4, 4, 20, 32), whisper_frames=60,
            decode_granite=(3, 6, 2, 70, 32),
            decode_whisper_cross=(3, 4, 4, 60, 32),
            corr=(4, 40, 70), wkv=(1, 4, 140, 16), wkv_decode=(3, 4, 1, 16),
            lru=(1, 160, 64), lru_decode=(3, 1, 64),
            serve_smoke=True, serve_requests=6, serve_requests_recurrent=6,
            serve_slots=3, serve_prompt=(4, 24), serve_new=(2, 6),
            serve_check_len=24, serve_check_len_window=24,
            serve_prompt_whisper=(4, 20), serve_max_len_whisper=30,
            profile_steps=1,
            train_smoke=True, train_batch=4, train_seq=16,
            train_check_batch=(2, 8),
            dist_elems=1 << 10, dist_matmul=(64, 128, 32),
            dist_decode=(3, 4, 4, 72, 32), dist_train_steps=2,
            tp_flash=(1, 1, 1, 24, 16), tp_decode=(3, 1, 1, 70, 16),
            tp_requests=4, tp_prompt=(4, 24), tp_new=3, tp_max_len=40,
            tp_check_len=24, tp_f32_steps=2, tp_train_batch=(4, 16),
            tp_flash_granite=(1, 1, 1, 24, 12),
            tp_decode_granite=(3, 1, 1, 70, 12),
            tp_wkv=(1, 1, 140, 16), tp_wkv_decode=(3, 1, 1, 16),
            tp_lru=(1, 200, 16), tp_lru_decode=(3, 1, 16),
            tp_flash_whisper_encoder=(1, 1, 1, 60, 16),
            tp_flash_whisper_self=(1, 1, 1, 20, 16),
            tp_decode_whisper_self=(3, 1, 1, 30, 16),
            tp_decode_whisper_cross=(3, 1, 1, 60, 16),
            tp_requests_added=4, tp_new_added=3,
            tp_train_batch_recurrent=(4, 16), tp_seq_slots=4,
            tp_decode_gemma_seq=(3, 4, 1, 10, 64),
            dryrun_archs=("granite-moe-1b-a400m", "rwkv6-3b"),
            reps=1)

#: the tp phase's served archs, in turn: phi3-mini, granite-moe-3b-a800m
#: (10 of 40 experts a rank), rwkv6-3b (10 of 40 WKV heads),
#: recurrentgemma-2b (640 of 2560 recurrent channels, 2.5 query heads a
#: rank gathered whole) and whisper-medium (4 of 16 heads), at full width
#: and depth by the phi3 traffic (whisper's inside its 448-token context)
TP_SERVE_ARCHS = ("phi3-mini-3.8b", "granite-moe-3b-a800m", "rwkv6-3b",
                  "recurrentgemma-2b", "whisper-medium")
#: the tp phase's trained archs, in turn: gemma-2b, granite-moe-1b-a400m
#: (8 of 32 experts a rank), rwkv6-3b, recurrentgemma-2b and whisper-medium
#: at full width and depth as gemma-2b is
TP_TRAIN_ARCHS = ("gemma-2b", "granite-moe-1b-a400m", "rwkv6-3b",
                  "recurrentgemma-2b", "whisper-medium")
#: the tp phase's served cells over other meshes, (arch, (data, model),
#: shard_seq), in turn: gemma-2b over (1, 4) with its decode cache split
#: by sequence over "model" (its one KV head leaves the axis to the
#: sequence: a run of max_len / 4 positions a rank, the ranks' partials
#: combined by their lse), and phi3-mini-3.8b over (2, 2) (4 of the 8
#: slots a data rank, 16 of 32 heads a model rank)
TP_SEQ_CELLS = (("gemma-2b", (1, 4), True),
                ("phi3-mini-3.8b", (2, 2), False))


def seq_cell_key(arch: str, shape: tuple, shard_seq: bool) -> str:
    """A served cell's name: ``gemma-2b@1x4/shard_seq``."""
    return (f"{arch}@{shape[0]}x{shape[1]}"
            + ("/shard_seq" if shard_seq else ""))


KM_F, KM_K = 4, 40  # the paper's K-Means: 4 features, 40 clusters
CS_R, CS_C = 8, 6  # co-clustering example: 8 row and 6 column clusters
RISKFREE = 0.02  # Black-Scholes' default rate, for put-call parity
#: the MD5 target sits this far below n, so that every block of keys runs
MD5_PLANT_BELOW_N = 4099
MD5_NO_MATCH = (1, 2, 3, 4)  # a digest no key of the runs has
#: elements compared at a time, so that float64 copies stay small
CHECK_SLAB = 1 << 26


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def require(cond, *what) -> None:
    """A check that fails the run (kept under ``python -O``, unlike assert)."""
    if not cond:
        raise AssertionError(" ".join(str(w) for w in what) or "check failed")


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


#: host seconds a kernel call may take (checks, allocations, the ctypes
#: call), covered by the device sleep ahead of queued calls
KERNEL_HOST_S = 1e-3
SM_CLOCK_HZ = 1.98e9  # boost clock: the sleep counts cycles


def time_ms(fn, device: torch.device, reps: int, warmup: bool = True,
            queued: float = 0.0) -> float | None:
    """Median of ``reps`` runs after one warm-up, by CUDA events.  Every
    timed shape is larger than the L2 cache, so no flush is needed.  A
    plain version that takes seconds is timed once, without a warm-up.
    ``queued`` (host seconds a call may take): for calls shorter than their
    own host work, the ``reps`` calls are enqueued behind a device sleep
    that long, and timed back to back between two events, so that the mean
    is the device's time and not the host's."""
    if warmup or device.type != "cuda":
        fn()
        sync(device)
    if device.type != "cuda":
        return None  # a rehearsal measures nothing
    if queued:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(reps * queued * SM_CLOCK_HZ))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check_close(name: str, got: torch.Tensor, want: torch.Tensor, *,
                rtol: float, atol: float) -> tuple[float, float]:
    """``|got - want| <= atol + rtol * |want|`` everywhere, else fail.
    Returns the largest absolute and relative (over nonzero ``want``)
    differences.  Compared in float64, ``CHECK_SLAB`` elements at a time."""
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    got, want = got.reshape(-1), want.reshape(-1)
    bad, abs_err, rel_err = 0, 0.0, 0.0
    for lo in range(0, got.numel(), CHECK_SLAB):
        g = got[lo:lo + CHECK_SLAB].double()
        w = want[lo:lo + CHECK_SLAB].double()
        if not torch.isfinite(g).all():
            raise AssertionError(f"{name}: result has non-finite values")
        diff = (g - w).abs()
        bad += int((diff > atol + rtol * w.abs()).sum())
        abs_err = max(abs_err, float(diff.max()))
        nonzero = w != 0
        if nonzero.any():
            rel_err = max(rel_err,
                          float((diff[nonzero] / w[nonzero].abs()).max()))
    if bad:
        raise AssertionError(
            f"{name}: {bad} of {got.numel()} elements outside "
            f"rtol={rtol} atol={atol} (max abs {abs_err:.3e}, max rel "
            f"{rel_err:.3e})")
    return abs_err, rel_err


def bound(bytes_moved: float, operations: float,
          op_rate: float) -> tuple[float, str]:
    """Least time in ms the card could take: each input read once and each
    output written once at the memory rate, or the operations at the peak
    rate of their type, whichever is larger (H100 SXM data-sheet peaks)."""
    t_bytes = bytes_moved / H100_SXM_HBM_BYTES_PER_S * 1e3
    t_ops = operations / op_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Inputs, made on the device from a seed
# ---------------------------------------------------------------------------


def lattice_centers(gen: torch.Generator, device) -> torch.Tensor:
    """``KM_K`` cluster centres on the lattice {0, 3, 6}^4: no two closer
    than 3, so with noise bounded by 0.5 no point lies near a bisector and
    the exact-count comparison cannot flip on rounding."""
    grid = torch.cartesian_prod(*[torch.tensor([0.0, 3.0, 6.0])] * KM_F)
    pick = torch.randperm(grid.shape[0], generator=gen, device=device)[:KM_K]
    return grid.to(device)[pick].contiguous()


def clustered_points(n: int, centers: torch.Tensor,
                     gen: torch.Generator) -> torch.Tensor:
    device = centers.device
    which = torch.randint(0, centers.shape[0], (n,), generator=gen,
                          device=device)
    pts = torch.rand((n, centers.shape[1]), generator=gen, device=device)
    pts.sub_(0.5).add_(centers[which])
    return pts


def start_centroids(centers: torch.Tensor,
                    gen: torch.Generator) -> torch.Tensor:
    jitter = torch.rand(centers.shape, generator=gen, device=centers.device)
    return centers + 0.4 * (jitter - 0.5)


def kmeans_inputs(n, k, f, gen, device):
    """(points, centroids): around the lattice centres at the paper's
    (k, f) = (KM_K, KM_F); at any other (k, f) around centres 4 apart on
    the diagonal.  Either way the clusters are separated, so that the
    counts compare exactly."""
    if (k, f) == (KM_K, KM_F):
        centers = lattice_centers(gen, device)
    else:
        centers = 4.0 * torch.arange(k, device=device, dtype=torch.float32
                                     )[:, None].repeat(1, f)
    return clustered_points(n, centers, gen), start_centroids(centers, gen)


def kmeans_check(name, got, want, points):
    """Counts exactly equal (integers; separated clusters), summing to n;
    sums within rtol 1e-4 atol 1e-3 (another order of summation)."""
    if not torch.equal(got[1], want[1]):
        raise AssertionError(f"{name}: counts differ: "
                             f"{(got[1] - want[1]).abs().max()}")
    # Summed in float64: exact for integer counts, where an f32 sum of
    # exact counts of 2^26 points misses n about half the time.
    require(float(got[1].double().sum()) == float(points.shape[0]), name,
            "counts do not sum to n")
    return check_close(name, got[0], want[0], rtol=1e-4, atol=1e-3)


def hotspot_inputs(shape, gen, device):
    temp = 60.0 + 30.0 * torch.rand(shape, generator=gen, device=device)
    power = 0.25 * torch.rand(shape, generator=gen, device=device)
    return temp, power


def csums_inputs(shape, gen, device):
    n, m = shape
    z = torch.rand(shape, generator=gen, device=device)
    ra = torch.randint(0, CS_R, (n,), generator=gen, device=device,
                       dtype=torch.int32)
    ca = torch.randint(0, CS_C, (m,), generator=gen, device=device,
                       dtype=torch.int32)
    return z, ra, ca


def gemm_inputs(m, k, n, dtype, gen, device):
    # Scaled so that C is of order 1: the absolute tolerance then means the
    # same at k = 8192 as in the reference's sweep at k of a few hundred.
    scale = float(k) ** -0.25
    a = (torch.randn((m, k), generator=gen, device=device) * scale).to(dtype)
    b = (torch.randn((k, n), generator=gen, device=device) * scale).to(dtype)
    return a, b


def bs_inputs(n, gen, device):
    """Prices, strikes and years with the reference sweep's distributions
    (5 + 25|N|, 1 + 99|N|, 0.25 + 9|N|)."""
    def make(lo, scale):
        return torch.randn((n,), generator=gen, device=device).abs_() \
            .mul_(scale).add_(lo)
    return make(5.0, 25.0), make(1.0, 99.0), make(0.25, 9.0)


def spmv_inputs(rows, nnz, n, gen, device):
    """The reference sweep's ELL matrix: entries uniform in [0, 1) with
    about 70 % nonzero, columns uniform in [0, n); x uniform."""
    data = torch.rand((rows, nnz), generator=gen, device=device)
    data.mul_(torch.rand((rows, nnz), generator=gen, device=device) < 0.7)
    cols = torch.randint(0, n, (rows, nnz), generator=gen, device=device,
                         dtype=torch.int32)
    return data, cols, torch.rand((n,), generator=gen, device=device)


def spmv_ragged_inputs(nnz, gen, device):
    """(300, nnz) with columns out of range: -1 reads x[n-1], n and n + 5
    read 0 (the reference kernel's fill mode)."""
    data, cols, x = spmv_inputs(300, nnz, 300, gen, device)
    cols[::7, 0] = -1
    cols[1::7, 5] = 300
    cols[2::7, 10] = 305
    return data, cols, x


def spmv_bin_inputs(shape, gen, device, nan_under_zeros=False):
    """(rows, max_nnz, n) with columns out of range (-1 reads x[n-1]; n,
    n + 5 and -n - 3 read 0) and, with ``nan_under_zeros``, NaN in x at
    the columns of five zero entries (so y is NaN in their rows, as the
    reference's 0 * NaN gives)."""
    rows, nnz, n = shape
    data, cols, x = spmv_inputs(rows, nnz, n, gen, device)
    cols[::7, 0] = -1
    cols[1::7, 3 % nnz] = n
    cols[2::7, 5 % nnz] = n + 5
    cols[3::7, 7 % nnz] = -n - 3
    if nan_under_zeros:
        zero = (data == 0).nonzero()[:5]
        x[cols[zero[:, 0], zero[:, 1]] % n] = float("nan")
    return data, cols, x


#: SpMV against its plain version: the reference sweep's rtol and atol
#: (another order of a sum of max_nnz terms), NaN exactly where the plain
#: version has NaN
SPMV_TOL = (1e-5, 1e-6)


def spmv_limit_share(got, want) -> float:
    """``close_share`` at ``SPMV_TOL`` off the rows where ``want`` is NaN,
    and inf where the NaN rows differ."""
    nan = torch.isnan(want)
    if not torch.equal(torch.isnan(got), nan):
        return float("inf")
    return close_share(got[~nan], want[~nan], *SPMV_TOL) if (~nan).any() \
        else 0.0


def spmv_check(name, got, want, *inputs):
    """y within ``SPMV_TOL`` of the plain version, NaN in the same rows."""
    nan = torch.isnan(want)
    require(torch.equal(torch.isnan(got), nan), name, "NaN in other rows "
            "than the plain version's")
    rtol, atol = SPMV_TOL
    return check_close(name, got[~nan], want[~nan], rtol=rtol, atol=atol)


def spmv_bin_faults(shape, gen, device) -> list[dict]:
    """Route "bin" on a ragged shape with NaN in x under zero entries,
    held to the plain version (``spmv_check``), and two planted faults
    built from its plain passes that must fail that check: one tile's
    entries dropped (the middle slice of the middle count block), and the
    zero entries skipped though x holds NaN (the finite flag ignored)."""
    data, cols, x = spmv_bin_inputs(shape, gen, device, nan_under_zeros=True)
    want = spmv_ell_ref(data, cols, x)
    require(bool(torch.isnan(want).any()), "no NaN row to hold")
    got = spmv_ell(data, cols, x)
    sync(device)
    spmv_check("spmv_ell/bin faults' input", got, want)
    rows, nnz = data.shape
    lay = bin_layout(rows, nnz, x.shape[0])
    tiles = {"slices": lay["slices"], "block_row_bits": lay["block_row_bits"]}
    offsets, packed, values = bin_entries(data, cols, x)
    seg = lay["count_blocks"] // 2 * lay["slices"] + lay["slices"] // 2
    dropped = values.clone()
    dropped[int(offsets[seg]):int(offsets[seg + 1])] = 0.0
    finite = torch.nan_to_num(x, nan=0.0)
    faults = {
        "tile_dropped": gather_bins(offsets, packed, dropped, x, rows,
                                    **tiles),
        "finite_flag_ignored": gather_bins(*bin_entries(data, cols, finite),
                                           x, rows, **tiles),
    }
    return require_caught("spmv_ell", [
        {"fault": label, "limit_share": spmv_limit_share(out, want)}
        for label, out in faults.items()])


def ell_to_csr(data, cols, x):
    """The same matrix as a CSR tensor (every ELL entry kept, zeros too),
    for the library's SpMV; built outside the timed region."""
    rows, nnz = data.shape
    crow = torch.arange(0, rows * nnz + 1, nnz, dtype=torch.int32,
                        device=data.device)
    csr = torch.sparse_csr_tensor(crow, cols.reshape(-1), data.reshape(-1),
                                  size=(rows, x.shape[0]),
                                  check_invariants=False)
    return csr, x


def md5_digest(key: int) -> tuple[int, int, int, int]:
    """The digest the search looks for when the answer is ``key``."""
    w0 = torch.tensor([key & 0xFFFFFFFF], dtype=torch.int64)
    return tuple(int(v[0]) for v in md5_u32x2(w0, w0 ^ KEY_XOR))


def md5_int_ops_per_key() -> dict:
    """The fewest 32-bit integer instructions one key of the search needs,
    counted from the rounds with every constant folded, the target's last
    eight rounds undone once a search (route "unwind"): rounds 1-52 and
    the test of b after round 52, by the pipes that can run them.  A round
    is the 3-input logic function (one LOP3), ``a + f + (K + m[g])`` (one
    IADD3, as K + m[g] folds to a constant; two where m[g] is a key word)
    and ``b + rotl(sum, s)``.  Round 1 works on constants until it adds w0:
    its rotate-add and one add.  Rounds 2-4 add to a constant ``a``, so a
    key word costs them nothing more.  Then the second message word (one
    LOP3, the xor) and the test, ``b + w1 == T`` (an add and an ISETP).

    ``alu_only``: the LOP3s, the xor and the ISETP, which only the ALU pipe
    runs.  ``rotate_adds``: one a round, each one ALU instruction (LEA.HI,
    a funnel shift and add) or two on the FMA pipe (IMAD.HI and IMAD, as
    ``md5.cu``'s ``kRotateOnFma`` form writes it).  ``adds``: the rest,
    each one instruction on either pipe (IADD3, or IMAD by a 1).
    ``total``: all of them with every rotate-add as one instruction."""
    rounds = UNWIND_TEST_ROUNDS
    key_word_rounds = sum(word_index(i) in (0, 1) for i in range(4, rounds))
    total = 2 + (rounds - 1) * 3 + key_word_rounds + 1 + 2
    alu_only = (rounds - 1) + 1 + 1  # LOP3s, the xor, the ISETP
    return {"total": total, "alu_only": alu_only, "rotate_adds": rounds,
            "adds": total - alu_only - rounds}


def md5_seconds_per_key(ops: dict) -> tuple[float, float]:
    """(seconds, rotate-adds on the FMA pipe) of one key at the least time
    over where its instructions run: r of its rotate-adds as two FMA-pipe
    instructions each, the rest on the ALU pipe with the ALU-only ones, and
    the adds on either.  Each pipe runs 64 lanes an SM
    (``H100_SXM_INT32_ALU_OPS``; IMAD.HI taken at that rate too, though it
    may issue slower), the two together the issue ceiling
    (``H100_SXM_INT32_OPS``, twice that).  With the adds split to even the
    pipes, the time is the largest of the issue time, the ALU pipe's with
    no adds and the FMA pipe's with none: lines in r, least at r = 0, at
    every rotate-add moved, or where two of them cross."""
    issue, pipe = H100_SXM_INT32_OPS, H100_SXM_INT32_ALU_OPS
    alu = ops["alu_only"] + ops["rotate_adds"]

    def seconds(r: float) -> float:
        return max((ops["total"] + r) / issue, (alu - r) / pipe,
                   2 * r / pipe)

    crossings = [0.0, ops["rotate_adds"],
                 (issue * alu - pipe * ops["total"]) / (issue + pipe),
                 alu / 3]
    r = min((min(max(c, 0.0), ops["rotate_adds"]) for c in crossings),
            key=seconds)
    return seconds(r), r


def md5_work(n, *_):
    """The search's least time: its instructions, where they run best
    (``md5_seconds_per_key``), for n keys; 16 bytes of target read, one int
    written."""
    per_key, _ = md5_seconds_per_key(md5_int_ops_per_key())
    # as issue-ceiling instructions, so ``bound`` takes it at that rate
    return bound(20.0, float(n) * per_key * H100_SXM_INT32_OPS,
                 H100_SXM_INT32_OPS)


#: MD5's planted faults: where the key is planted, the unwound round given
#: a wrong message word (round 63 reads m[2] = 0x80), and the word it gets
MD5_WRONG_WORD = (62, 0)


def md5_faults(n: int, target, expect: int, device) -> list[dict]:
    """Route "unwind"'s launch handed values a fault would give: the
    target unwound with one round's message word wrong, and the test after
    round 52 made against round 53's value (b after round 53, the unwound
    a) in place of T.  Each must miss the key planted at ``expect``."""
    state = md5_unwind(target)
    wrong = md5_final_state(target)
    constant = md5_message(None, None)
    for i in range(63, 55, -1):
        word = MD5_WRONG_WORD[1] if i == MD5_WRONG_WORD[0] \
            else constant[word_index(i)]
        wrong = md5_unround(wrong, i, word)
    rows = []
    for label, st, word1 in (
            ("unwound_round_wrong_word", wrong, md5_word1_target(wrong)),
            ("test_at_round_53", state, state[0])):
        found = int(md5_unwound_search_cuda(n, st, word1, device)[0])
        require(found != expect, "planted fault md5/" + label,
                "still found the key", expect)
        rows.append({"fault": label, "found": found, "missed": True})
    return rows


def nbody_inputs(n, gen, device, softening2=SOFTENING2, zero_every=0):
    """Positions uniform in the unit cube, masses uniform in [0.5, 1.5)
    (the reference sweep's bodies), every ``zero_every``-th body of zero
    mass; and eps^2."""
    posm = torch.rand((n, 4), generator=gen, device=device)
    posm[:, 3] += 0.5
    if zero_every:
        posm[::zero_every, 3] = 0.0
    return posm, softening2


#: flops one N-Body pair needs: 3 subtractions, |d|^2 + eps^2 (3 multiply-
#: adds, 6 flops), rsqrt (1), m / dist^3 (3 multiplies), 3 multiply-adds
#: into the sum (6)
NBODY_FLOPS_PER_PAIR = 19
#: issue slots an ordered pair needs at least: 3 FADD, 3 FFMA (|d|^2, eps^2
#: folded), 3 FMUL (m r^3), 3 FFMA (the sums), 1 MUFU.RSQ; at the issue
#: ceiling, the least time of any route that evaluates each ordered pair
NBODY_ORDERED_SLOTS = 13
#: N-Body's ragged case by route "tile": a last source tile of 37 bodies,
#: every 7th body of zero mass
NBODY_RAGGED_TILE = 4133


def nbody_ordered_floor_ms(n: int) -> float:
    """``NBODY_ORDERED_SLOTS`` a pair over n^2 ordered pairs at the issue
    ceiling (``H100_SXM_INT32_OPS``: one warp instruction a clock on each
    scheduler, whatever its type)."""
    return NBODY_ORDERED_SLOTS * float(n) ** 2 / H100_SXM_INT32_OPS * 1e3


def bs_check(name, got, want, price, strike, years):
    """Both outputs against the plain version, and put-call parity
    ``call - put = S - K exp(-rT)`` in float64 (so that only the
    kernel's rounding counts)."""
    # rtol 1e-4 atol 2e-4: the reference sweep's, for erf/log/exp rounding.
    err_c = check_close(f"{name}/call", got[0], want[0], rtol=1e-4, atol=2e-4)
    err_p = check_close(f"{name}/put", got[1], want[1], rtol=1e-4, atol=2e-4)
    worst = 0.0
    for lo in range(0, price.numel(), CHECK_SLAB):
        sl = slice(lo, lo + CHECK_SLAB)
        lhs = got[0][sl].double() - got[1][sl].double()
        rhs = price[sl].double() - strike[sl].double() * torch.exp(
            -RISKFREE * years[sl].double())
        worst = max(worst, float((lhs - rhs).abs().max()))
    # atol 5e-4: the reference's parity tolerance.
    require(worst <= 5e-4, name, "put-call parity off by", worst)
    return max(err_c[0], err_p[0]), max(err_c[1], err_p[1])


def nbody_term_scale(posm, lo, hi, softening2=SOFTENING2):
    """``sum_j |term_ij|`` for targets [lo, hi), per axis, in posm's type:
    the size of the sum that an N-Body error is held against."""
    pos, mass = posm[:, :3], posm[:, 3]
    d = pos[None, :, :] - pos[lo:hi, None, :]
    dist2 = (d * d).sum(dim=-1) + softening2
    return torch.einsum("ij,ijk->ik",
                        mass[None, :] * torch.rsqrt(dist2) / dist2, d.abs())


def nbody_slab_check(name, got, plain, posm, lo, hi, softening2=SOFTENING2):
    """Accelerations of targets [lo, hi) against the plain version in
    float64, per target and axis within ``1e-4 * sum_j |term_ij|``: a sum
    of n f32 terms cannot be held to an absolute 5e-4 at n = 2**17.  The
    kernel's rows (``got``) and the f32 plain version's (``plain``) both."""
    p64 = posm.double()
    want = nbody_forces_ref(p64, softening2, rows=(lo, hi))
    scale = nbody_term_scale(p64, lo, hi, softening2)
    worst = (0.0, 0.0)
    for label, a in (("kernel", got), ("plain f32", plain)):
        err = (a.double() - want).abs()
        if not torch.isfinite(a).all() or (err > 1e-4 * scale).any():
            raise AssertionError(
                f"{name}: {label} off by {float((err / scale).max()):.3e} "
                "of sum |term| (limit 1e-4)")
        if label == "kernel":
            worst = (float(err.max()),
                     float((err / want.abs().clamp_min(1e-300)).max()))
    return worst


def nbody_check(name, got, want, posm, softening2, slab=1024):
    """Every target against float64 within ``1e-4 * sum_j |term_ij|``
    (``nbody_slab_check``, kernel and f32 plain version, ``slab`` targets
    at a time), except for eps^2 = 0: there every self term is 0 * inf, so
    the kernel must give NaN exactly where the plain version does
    (everywhere)."""
    if softening2 == 0:
        same = torch.equal(torch.isnan(got), torch.isnan(want))
        require(same, name, "NaN pattern differs from the plain version's")
        return 0.0, 0.0
    worst = (0.0, 0.0)
    for lo in range(0, posm.shape[0], slab):
        hi = min(posm.shape[0], lo + slab)
        err = nbody_slab_check(name, got[lo:hi], want[lo:hi], posm, lo, hi,
                               softening2)
        worst = tuple(map(max, worst, err))
    return worst


def nbody_faults(posm, softening2=SOFTENING2) -> dict:
    """Route "tile"'s sums with a planted fault, from the plain version's
    pieces: one slice's partial dropped, and the last ragged source tile
    skipped (the sources past the last whole tile)."""
    n = posm.shape[0]
    slices = nbody_slices(n, NBODY_TILE_SLICES, NBODY_TILE)
    parts = [nbody_forces_ref(posm, softening2, cols=c) for c in slices]
    whole = n - n % NBODY_TILE
    require(whole < n and len(slices) > 1, "no ragged tile or one slice")
    cut = [nbody_forces_ref(posm, softening2, cols=(lo, min(hi, whole)))
           for lo, hi in slices]
    return {"slice_partial_dropped": sum(parts[:1] + parts[2:]),
            "ragged_tile_skipped": sum(cut)}


def nbody_fault_rows(posm, softening2=SOFTENING2) -> list[dict]:
    """Each of ``nbody_faults`` must fail ``nbody_check``'s limit."""
    rows = []
    for label, bad in nbody_faults(posm, softening2).items():
        try:
            nbody_check(f"planted fault nbody/{label}", bad, bad, posm,
                        softening2)
        except AssertionError as e:
            rows.append({"fault": label, "caught": str(e)[:200]})
            continue
        raise AssertionError(f"planted fault nbody/{label} passed the check")
    return rows


def attn_tensors(b, hq, hkv, s, t, d, dtype, gen, device):
    """q (b, hq, s, d), k and v (b, hkv, t, d): normal with std 0.5 (the
    reference sweep's inputs), made in f32 and cast to ``dtype``."""
    def normal(*shape):
        return (0.5 * torch.randn(shape, generator=gen, device=device)) \
            .to(dtype)
    return normal(b, hq, s, d), normal(b, hkv, t, d), normal(b, hkv, t, d)


def flash_inputs(shape, dtype, gen, device, t=None, **kw):
    """(q, k, v, keyword arguments) for a (B, HQ, HKV, S, D) shape; T = S
    unless given; causal unless the keywords say otherwise."""
    b, hq, hkv, s, d = shape
    return (*attn_tensors(b, hq, hkv, s, t or s, d, dtype, gen, device),
            {"causal": True, **kw})


def decode_inputs(shape, dtype, gen, device, kv_len=None):
    """(q, k, v, kv_len) for a (B, HQ, HKV, T, D) shape; ``kv_len`` spread
    over [1, T] with both ends present, unless one length is given."""
    b, hq, hkv, t, d = shape
    q, k, v = attn_tensors(b, hq, hkv, 1, t, d, dtype, gen, device)
    if kv_len is None:
        lens = torch.randint(1, t + 1, (b,), generator=gen, device=device)
        lens[0], lens[-1] = 1, t
    else:
        lens = torch.full((b,), kv_len, device=device)
    return q[:, :, 0].contiguous(), k, v, lens.to(torch.int32)


def rate_of(dtype: torch.dtype) -> float:
    return H100_SXM_BF16_FLOPS if dtype == torch.bfloat16 \
        else H100_SXM_FP32_FLOPS


def visible_pairs(s: int, t: int, causal: bool, window: int | None,
                  q_offset: int) -> int:
    """(query, key) pairs the masks let through: the work attention needs."""
    q = q_offset + np.arange(s)
    hi = np.minimum(q, t - 1) if causal else np.full(s, t - 1)
    lo = np.maximum(q - window + 1, 0) if window else np.zeros(s, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_work(q, k, v, kw):
    """q, k, v read and o written once; 4 D flops a visible pair (Q K^T
    and P V) at the peak of the inputs' type."""
    b, hq, s, d = q.shape
    pairs = visible_pairs(s, k.shape[2], kw.get("causal", True),
                          kw.get("window"), kw.get("q_offset", 0))
    return bound((2 * q.numel() + k.numel() + v.numel()) * q.element_size(),
                 4.0 * b * hq * d * pairs, rate_of(q.dtype))


def decode_work(q, k, v, kv_len):
    """K and V up to kv_len, q and out, and the f32 lse, once each; 4 D
    flops a (key, query head)."""
    b, hq, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    keys = float(kv_len.clamp(max=t).sum())
    return bound(2 * hkv * d * keys * k.element_size()
                 + 2 * q.numel() * q.element_size() + 4 * b * hq,
                 4.0 * hq * d * keys, rate_of(q.dtype))


#: Attention tolerances against the plain version in the inputs' type: the
#: reference sweep's (tests/test_kernels.py): f32 2e-4 on the output (order
#: of summation) and 1e-4 on the lse; bf16 3e-2 (8 bits of mantissa; the
#: plain version also rounds its logits and probabilities to bf16 where the
#: kernels keep f32), lse alike.
ATTN_TOL = {torch.float32: (2e-4, 1e-4), torch.bfloat16: (3e-2, 3e-2)}
#: GEMM against its plain version: f32 1e-4 (true f32 products, another
#: order of summation); bf16 2e-2 (the result is rounded to bf16); a bf16
#: result is also held to the bf16 limit below.
GEMM_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
#: bf16's unit roundoff (8 significant bits)
BF16_U = 2.0 ** -8
#: A bf16 kernel is also held against the f32 plain version of the same
#: (bf16-valued) inputs, element by element, within
#: ``BF16_U * (2 |want| + 8 rms)``, ``rms`` over the row's head_dim.  The
#: kernels compute in f32 and round twice: the output to bf16 (at most
#: ``u |want|``; the second ``u`` covers the two f32 orders of summation),
#: and p to bf16 before P.V, as the reference kernel does, which adds a sum
#: of independent errors of standard deviation about ``u / sqrt(3)`` of the
#: row's rms: ``8 u rms`` is 14 of them.  The 3e-2 above is larger than a
#: typical output (about 0.5 / sqrt(keys) for these inputs), so only this
#: limit sees a dropped tile; ``planted_faults`` shows that it does.
BF16_OUT_ABS, BF16_OUT_RMS = 2.0, 8.0
#: the kernels' lse is f32 from unrounded p: the f32 limit, absolute
BF16_LSE_ATOL = 1e-4


def as_f32(inputs):
    """The inputs with every floating tensor widened to f32 (exactly)."""
    return tuple(x.float() if torch.is_tensor(x) and x.is_floating_point()
                 else x for x in inputs)


def bf16_gap(got: torch.Tensor, want: torch.Tensor) -> dict:
    """A bf16 attention output against the f32 plain version: the largest
    share of its element's limit that a difference takes (above 1 fails),
    the share of elements outside their limit, and the largest difference."""
    g, w = got.double(), want.double()
    rms = w.square().mean(-1, keepdim=True).sqrt()
    limit = BF16_U * (BF16_OUT_ABS * w.abs() + BF16_OUT_RMS * rms)
    diff = (g - w).abs()
    share = torch.where(diff == 0, torch.zeros_like(diff), diff / limit)
    share = torch.where(torch.isfinite(g), share,
                        torch.full_like(share, float("inf")))
    return {"limit_share": float(share.max()),
            "outside": float((share > 1).double().mean()),
            "max_abs_err": float(torch.nan_to_num(diff).max())}


def bf16_lse_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest lse difference over ``BF16_LSE_ATOL``."""
    return float(torch.nan_to_num((got.double() - want.double()).abs(),
                                  nan=float("inf")).max()) / BF16_LSE_ATOL


def bf16_check(name: str, out: torch.Tensor, want: torch.Tensor,
               lse=None, want_lse=None) -> dict:
    """The limit holds a kernel's result; a rehearsal's result on the CPU is
    the bf16 plain version, which rounds its logits to bf16 (its lse is off
    by about 1e-3), so there the gap is reported and not required."""
    gap = bf16_gap(out, want)
    if lse is not None:
        gap["lse_limit_share"] = bf16_lse_gap(lse, want_lse)
    worst = max(gap["limit_share"], gap.get("lse_limit_share", 0.0))
    require(worst <= 1.0 or not out.is_cuda, f"{name}: bf16 output outside "
            f"BF16_U * "
            f"({BF16_OUT_ABS} |want| + {BF16_OUT_RMS} rms) of the f32 plain "
            "version (lse 1e-4):", gap)
    return gap


def flash_check(name, got, want, *inputs):
    """Against the plain version in the inputs' type; in bf16 also against
    the f32 plain version (whose errors the row reports)."""
    tol = ATTN_TOL[got.dtype][0]
    err = check_close(name, got, want, rtol=tol, atol=tol)
    if got.dtype != torch.bfloat16:
        return err
    q, k, v, kw = as_f32(inputs)
    want32 = attention_ref(q, k, v, **kw)
    gap = bf16_check(name, got, want32)
    return gap["max_abs_err"], err[1], {
        "bf16_limit_share": gap["limit_share"],
        "bf16_plain_max_abs_err": err[0]}


def decode_check(name, got, want, *inputs):
    tol, lse_tol = ATTN_TOL[got[0].dtype]
    err = check_close(f"{name}/out", got[0], want[0], rtol=tol, atol=tol)
    check_close(f"{name}/lse", got[1], want[1], rtol=lse_tol, atol=lse_tol)
    if got[0].dtype != torch.bfloat16:
        return err
    q, k, v, n = as_f32(inputs)
    want32 = decode_attention_ref(q, k, v, kv_len=n, with_lse=True)
    gap = bf16_check(name, got[0], want32[0], got[1], want32[1])
    return gap["max_abs_err"], err[1], {
        "bf16_limit_share": gap["limit_share"],
        "bf16_lse_limit_share": gap["lse_limit_share"],
        "bf16_plain_max_abs_err": err[0]}


def masked_attention(q, k, v, keep):
    """f32 attention of q (B, HQ, S, D) on k, v (B, HKV, T, D) over the keys
    ``keep`` (broadcast to (B, HQ, S, T)) lets through; a row with none
    gives zeros, as the kernels do.  Returns (out, lse)."""
    group = q.shape[1] // k.shape[1]
    kk = k.float().repeat_interleave(group, 1)
    vv = v.float().repeat_interleave(group, 1)
    logits = torch.einsum("bhsd,bhtd->bhst", q.float(), kk) \
        / q.shape[-1] ** 0.5
    logits = logits.masked_fill(~keep, float("-inf"))
    m = logits.amax(-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(logits - m)
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bhst,bhtd->bhsd", p, vv) / l.clamp_min(1e-30)
    return out, (m + torch.log(l)).squeeze(-1)


def planted_faults(kind: str, inputs, want32) -> list[dict]:
    """Outputs of wrong kernels, made by the f32 plain computation with keys
    left out and rounded to bf16 like a kernel's output, held to the bf16
    limit: each must fail it, or the limit could not tell a wrong kernel
    from a right one.  Flash: one tile of keys past the middle dropped for
    the rows past it; the diagonal tile dropped for the second half of the
    rows; the output zeroed past a quarter of the rows.  Decode: one tile in
    the middle of each row's keys; each row's last, partial tile; the first
    quarter of the cache (one split's worth)."""
    if kind == "flash":
        q, k, v, kw = inputs
        require(kw.get("causal", True) and not kw.get("window")
                and not kw.get("q_offset"), "planted faults: plain causal")
        s, t = q.shape[2], k.shape[2]
        tile = min(64, t // 4)
        qpos = torch.arange(s, device=q.device)[:, None]
        kpos = torch.arange(t, device=q.device)[None, :]
        causal = kpos <= qpos
        t0 = (t // 2) // tile * tile
        diag = (kpos // tile == qpos // tile) & (qpos >= s // 2)
        zeroed = want32.clone()
        zeroed[:, :, s // 4:] = 0
        faults = {
            "kv_tile_dropped": masked_attention(
                q, k, v, causal & ~((kpos >= t0) & (kpos < t0 + tile)
                                    & (qpos >= t0 + tile)))[0],
            "diagonal_tile_dropped": masked_attention(
                q, k, v, causal & ~diag)[0],
            "rows_zeroed": zeroed,
        }
        want_lse = None
    else:
        q, k, v, n = inputs
        t = k.shape[2]
        tile = min(64, t // 4)
        kpos = torch.arange(t, device=q.device)[None, :]
        n = n.long()[:, None]
        valid = kpos < n
        mid = (n // 2) // tile * tile
        last = (n - 1) // tile * tile
        want_lse = want32[1]
        want32 = want32[0]
        faults = {}
        for label, drop in (
                ("mid_tile_dropped", (kpos >= mid) & (kpos < mid + tile)
                 & (n > 2 * tile)),
                ("last_tile_dropped", (kpos >= last) & (n > tile)),
                ("split_dropped", (kpos < t // 4) & (n > t // 4))):
            keep = (valid & ~drop)[:, None, None, :]
            out, lse = masked_attention(q[:, :, None], k, v, keep)
            faults[label] = (out[:, :, 0], lse[:, :, 0])
    rows = []
    for label, fault in faults.items():
        out, lse = fault if isinstance(fault, tuple) else (fault, None)
        gap = bf16_gap(out.to(torch.bfloat16), want32)
        if lse is not None:
            gap["lse_limit_share"] = bf16_lse_gap(lse, want_lse)
        caught = gap["limit_share"] > 1 or gap.get("lse_limit_share", 0) > 1
        require(caught, f"planted fault {label} passes the bf16 limit:", gap)
        rows.append({"fault": label, **gap})
    return rows


def flash_main_check(name, got, want, *inputs):
    abs_err, rel_err, extra = flash_check(name, got, want, *inputs)
    q, k, v, kw = as_f32(inputs)
    extra["planted_faults"] = planted_faults(
        "flash", inputs, attention_ref(q, k, v, **kw))
    return abs_err, rel_err, extra


def decode_main_check(name, got, want, *inputs):
    abs_err, rel_err, extra = decode_check(name, got, want, *inputs)
    q, k, v, n = as_f32(inputs)
    extra["planted_faults"] = planted_faults(
        "decode", inputs,
        decode_attention_ref(q, k, v, kv_len=n, with_lse=True))
    return abs_err, rel_err, extra


def gemm_check(name, got, want, a, b):
    """Against the plain version in the inputs' type (f32 1e-4: the order
    of summation; bf16 2e-2: the result's own rounding); in f32 also
    against a float64 product within the reference sweep's 1e-4
    (``tests/test_kernels.py``), the plain version's error (cuBLAS in true
    f32) reported beside it; in bf16 also against the f32 product of the
    same inputs within the bf16 limit (``bf16_check``, rms over a row of
    C)."""
    tol = GEMM_TOL[got.dtype]
    err = check_close(name, got, want, rtol=tol, atol=tol)
    if got.dtype == torch.float32:
        want64 = a.double() @ b.double()
        err64 = check_close(f"{name}/float64", got, want64, rtol=tol,
                            atol=tol)
        plain64 = float((want.double() - want64).abs().max())
        return err[0], err[1], {"f64_max_abs_err": err64[0],
                                "f64_max_rel_err": err64[1],
                                "plain_f64_max_abs_err": plain64}
    if got.dtype != torch.bfloat16:
        return err
    gap = bf16_check(name, got, gemm_ref(a, b, out_dtype=torch.float32))
    return gap["max_abs_err"], err[1], {
        "bf16_limit_share": gap["limit_share"],
        "bf16_plain_max_abs_err": err[0]}


def gemm_faults(a, b) -> list[dict]:
    """A product with one 64-deep K stage dropped (the one past the middle
    of K, as a ring slot the consumers skipped would drop it), rounded to
    bf16 like the kernel's output: it must fail the bf16 limit."""
    k = a.shape[1]
    k0 = (k // 2) // 64 * 64
    kk = slice(k0, min(k0 + 64, k))
    want32 = gemm_ref(a, b, out_dtype=torch.float32)
    dropped = want32 - gemm_ref(a[:, kk].contiguous(), b[kk].contiguous(),
                                out_dtype=torch.float32)
    gap = bf16_gap(dropped.to(torch.bfloat16), want32)
    require(gap["limit_share"] > 1, "planted fault k_stage_dropped passes "
            "the bf16 limit:", gap)
    return [{"fault": "k_stage_dropped", "k": [k0, kk.stop], **gap}]


def gemm_main_check(name, got, want, a, b):
    abs_err, rel_err, *extra = gemm_check(name, got, want, a, b)
    if got.dtype != torch.bfloat16:
        return abs_err, rel_err, *extra
    extra[0]["planted_faults"] = gemm_faults(a, b)
    return abs_err, rel_err, extra[0]


def sdpa_decode_setup(q, k, v, kv_len):
    """The library call's arguments: q as one query row, kv_len as a mask
    (built outside the timed region)."""
    mask = torch.arange(k.shape[2], device=q.device)[None, :] \
        < kv_len[:, None]
    return q[:, :, None], k, v, mask[:, None, None, :]


def close_share(got: torch.Tensor, want: torch.Tensor, rtol: float,
                atol: float) -> float:
    """The largest ``|got - want| / (atol + rtol |want|)`` (above 1 is
    outside the tolerance), in float64, ``CHECK_SLAB`` elements at a
    time."""
    got, want = got.reshape(-1), want.reshape(-1)
    worst = 0.0
    for lo in range(0, got.numel(), CHECK_SLAB):
        g = got[lo:lo + CHECK_SLAB].double()
        w = want[lo:lo + CHECK_SLAB].double()
        share = (g - w).abs() / (atol + rtol * w.abs())
        worst = max(worst, float(torch.nan_to_num(share, nan=float("inf"))
                                 .max()))
    return worst


def require_caught(kind: str, rows: list[dict]) -> list[dict]:
    """Each planted fault must use more than its whole limit."""
    for row in rows:
        require(row["limit_share"] > 1, f"planted fault {kind}/{row['fault']}"
                " passes the limit:", row)
    return rows


#: The correlator against its plain version: the reference sweep's rtol and
#: atol (f32 sums of 4 T products in another order).
CORR_TOL = 1e-4


def corr_inputs(c, t, a, gen, device, dtype=torch.float32):
    """Samples (C, T, A, 2) in ``dtype``: re and im normal with std 0.5
    (the reference sweep's)."""
    return ((0.5 * torch.randn((c, t, a, 2), generator=gen, device=device)
             ).to(dtype),)


def mirrored_tiles(a: int, device) -> torch.Tensor:
    """(A, A) mask of the pairs (i, j) whose 64-antenna tile row lies past
    its tile column: the tiles route "tri" writes as conjugate transposes."""
    tile = torch.arange(a, device=device) // CORR_TILE
    return tile[:, None] > tile[None, :]


def corr_mirror_misses(got: torch.Tensor) -> int:
    """Pairs of the mirrored tiles that are not bit-exactly conj(V[j, i])."""
    lower = mirrored_tiles(got.shape[1], got.device)
    conj_t = torch.stack([got[..., 0].transpose(1, 2),
                          -got[..., 1].transpose(1, 2)], dim=-1)
    return int((got != conj_t)[:, lower].sum())


def corr_check(name, got, want, samples):
    """Against the plain version, and Hermitian: V[i,j] = conj(V[j,i]).
    bf16 visibilities (summed in f32, rounded once) against the f32 plain
    version of the same samples within the bf16 limit, the rms over a row
    of V.  A result of route "tri" is also Hermitian bit for bit off the
    diagonal tiles."""
    if got.is_cuda and correlate_route(samples) == "tri":
        misses = corr_mirror_misses(got)
        require(misses == 0, name, misses, "mirrored pairs are not the "
                "conjugates of their transposes")
    if got.dtype == torch.bfloat16:
        c, a = got.shape[:2]
        want32 = correlate_ref(samples.float())
        gap = bf16_check(name, got.reshape(c, a, 2 * a),
                         want32.reshape(c, a, 2 * a))
        return gap["max_abs_err"], 0.0
    err = check_close(name, got, want, rtol=CORR_TOL, atol=CORR_TOL)
    check_close(f"{name}/hermitian re", got[..., 0],
                got[..., 0].transpose(1, 2), rtol=CORR_TOL, atol=CORR_TOL)
    check_close(f"{name}/hermitian im", got[..., 1],
                -got[..., 1].transpose(1, 2), rtol=CORR_TOL, atol=CORR_TOL)
    return err


def corr_main_check(name, got, want, samples):
    """``corr_check``, then planted faults that must fail its tolerance: one
    time tile (16 samples, the kernel's stage) dropped; the imaginary
    part's sign flipped (V^T in place of V); route "tri"'s mirrored tiles
    left at zero, and mirrored without the conjugation."""
    abs_err, rel_err = corr_check(name, got, want, samples)
    t = samples.shape[1]
    t0 = (t // 2) // 16 * 16
    dropped = samples.clone()
    dropped[:, t0:t0 + 16] = 0
    lower = mirrored_tiles(samples.shape[2], samples.device)
    require(bool(lower.any()), name, "has no mirrored tiles")
    unmirrored = want.clone()
    unmirrored[:, lower] = 0
    unconjugated = want.clone()
    unconjugated[:, lower, 1] = -unconjugated[:, lower, 1]
    faults = {"time_tile_dropped": correlate_ref(dropped),
              "im_sign_flipped": torch.stack([want[..., 0], -want[..., 1]],
                                             dim=-1),
              "mirror_left_zero": unmirrored,
              "mirror_not_conjugated": unconjugated}
    del dropped, unmirrored, unconjugated
    rows = [{"fault": label, "limit_share": close_share(out, want, CORR_TOL,
                                                        CORR_TOL)}
            for label, out in faults.items()]
    return abs_err, rel_err, {"planted_faults": require_caught("correlate",
                                                               rows)}


def corr_setup(samples):
    """The library call's argument: the samples as complex (C, T, A)."""
    return (torch.view_as_complex(samples),)


def corr_work(samples):
    """Samples read and visibilities written once; 8 flops a pair and
    sample (four real multiply-adds) over the pairs i <= j only, A (A + 1)
    / 2 of them: V is Hermitian, so the other half is a copy with the
    imaginary part negated.  At the f32 peak."""
    c, t, a, _ = samples.shape
    return bound((samples.numel() + 2 * c * a * a) * samples.element_size(),
                 8.0 * a * (a + 1) / 2 * t * c, H100_SXM_FP32_FLOPS)


#: The scans in f32 against their plain versions: the reference sweeps'
#: rtol and atol (another order of rounding over T steps).
SCAN_TOL = 1e-4


def wkv_inputs(b, h, t, dk, dv, dtype, gen, device):
    """(r, k, v, w, u, s0): r, k, v normal with std 0.5; decays
    exp(-exp(N(0, 1))), spread over (0, 1); bonus u normal with std 0.5 (the
    size of a trained model's, not the init's 0.02); a random initial state.
    r, k, v, w in ``dtype``; u and s0 f32."""
    def normal(*shape, std=0.5):
        return std * torch.randn(shape, generator=gen, device=device)
    r, k, v = normal(b, h, t, dk), normal(b, h, t, dk), normal(b, h, t, dv)
    w = torch.exp(-torch.exp(normal(b, h, t, dk, std=1.0)))
    return (r.to(dtype), k.to(dtype), v.to(dtype), w.to(dtype), normal(h, dk),
            normal(b, h, dk, dv))


def wkv_exact_decays(inputs):
    """``inputs`` with decays of exactly 0 at every 37th step (a reset) and
    exactly 1 at every 41st (no decay)."""
    r, k, v, w, u, s0 = inputs
    w = w.clone()
    w[:, :, ::37] = 0.0
    w[:, :, 5::41] = 1.0
    return r, k, v, w, u, s0


def lru_inputs(b, t, d, dtype, gen, device, sweep=False):
    """(log_a, gx, h0): log_a = -exp(U(-7, 1)), decays from 0.07 (a chain
    that forgets at once) to 0.999 (one that keeps a value for thousands of
    steps); gx and h0 normal.  ``sweep``: the reference sweep's
    -|N(0, 0.1)|.  log_a and gx in ``dtype``; h0 f32."""
    if sweep:
        la = -(0.1 * torch.randn((b, t, d), generator=gen, device=device)
               ).abs()
    else:
        la = -torch.exp(8.0 * torch.rand((b, t, d), generator=gen,
                                         device=device) - 7.0)
    gx = torch.randn((b, t, d), generator=gen, device=device)
    return (la.to(dtype), gx.to(dtype),
            torch.randn((b, d), generator=gen, device=device))


def lru_exact_decays(inputs):
    """``inputs`` with log_a of exactly 0 (a = 1, beta = 0: h carried
    unchanged) at every 37th step and -50 (a = 2e-22: a chunk's decay
    product underflows to 0, the carry resets) at every 41st."""
    la, gx, h0 = inputs
    la = la.clone()
    la[:, ::37] = 0.0
    la[:, 5::41] = -50.0
    return la, gx, h0


def lru_plain(la, gx, h0):
    """The public function's plain route: every h in gx's dtype, the final
    h in f32."""
    return rg_lru(la, gx, h0, return_state=True, use_ref=True)


def scan_check(plain32):
    """A check of a scan's (output, final state) against its plain version:
    in f32 within ``SCAN_TOL``; in bf16 within the bf16 limit of the f32
    plain version of the same (bf16-valued) inputs (``plain32``), with the
    gap to the plain version in bf16 reported beside it.  The kernels keep
    the state in f32 and round each output once, so the limit that holds an
    attention output holds these."""
    def check(name, got, want, *inputs):
        (out, state), (want_out, want_state) = got, want
        if out.dtype == torch.float32:
            e1 = check_close(name, out, want_out, rtol=SCAN_TOL, atol=SCAN_TOL)
            e2 = check_close(f"{name}/state", state, want_state,
                             rtol=SCAN_TOL, atol=SCAN_TOL)
            return max(e1[0], e2[0]), max(e1[1], e2[1])
        # The plain version in bf16 rounds where the kernel does not (the
        # WKV6 read, as the reference's wkv6_ref): its gap is reported, the
        # f32 plain version's is required.
        vs16 = bf16_gap(out, want_out)
        want32 = plain32(*as_f32(inputs))
        gap = bf16_check(name, out, want32[0])
        gap_state = bf16_check(f"{name}/state", state, want32[1])
        return gap["max_abs_err"], 0.0, {
            "bf16_limit_share": gap["limit_share"],
            "bf16_state_limit_share": gap_state["limit_share"],
            "bf16_plain_limit_share": vs16["limit_share"],
            "bf16_plain_max_abs_err": vs16["max_abs_err"]}
    return check


def scan_faults(kind: str, faults: dict, want32) -> list[dict]:
    """Outputs of wrong scans, made by the f32 plain computation and
    rounded to bf16 like a kernel's output, held to the bf16 limit: each
    must fail it."""
    rows = [{"fault": label, **bf16_gap(out.to(torch.bfloat16), want32)}
            for label, out in faults.items()]
    return require_caught(kind, rows)


wkv_check = scan_check(lambda *a: wkv6_ref(*a, return_state=True))
lru_check = scan_check(lru_plain)


def wkv_carry_fault(r, k, v, w, u, s0):
    """Route "chunk"'s three passes in plain PyTorch with one carried state
    not decayed across its chunk (P_c taken as 1 for the middle chunk)."""
    ds, decays = wkv6_chunk_updates(k, v, w, CHUNK_LEN)
    decays[:, :, decays.shape[2] // 2] = 1.0
    starts, _ = wkv6_chunk_carry(ds, decays, s0)
    return wkv6_chunk_outputs(r, k, v, w, u, starts, CHUNK_LEN)


def wkv_main_check(name, got, want, *inputs):
    """``wkv_check``, then planted faults: the bonus u dropped; one step's
    decay skipped (w = 1 at the middle step); the state zeroed in the
    middle of the sequence; route "chunk"'s carried state not decayed
    across the middle chunk."""
    abs_err, rel_err, extra = wkv_check(name, got, want, *inputs)
    r, k, v, w, u, s0 = as_f32(inputs)
    want32 = wkv6_ref(r, k, v, w, u, s0)
    mid = r.shape[2] // 2
    w_skip = w.clone()
    w_skip[:, :, mid] = 1.0
    halves = [wkv6_ref(r[:, :, sl], k[:, :, sl], v[:, :, sl], w[:, :, sl], u,
                       s) for sl, s in ((slice(0, mid), s0),
                                        (slice(mid, None),
                                         torch.zeros_like(s0)))]
    extra["planted_faults"] = scan_faults("wkv6", {
        "bonus_dropped": wkv6_ref(r, k, v, w, torch.zeros_like(u), s0),
        "decay_skipped_once": wkv6_ref(r, k, v, w_skip, u, s0),
        "state_zeroed_mid_sequence": torch.cat(halves, dim=2),
        "carry_not_decayed": wkv_carry_fault(r, k, v, w, u, s0),
    }, want32)
    return abs_err, rel_err, extra


#: the time step at which the planted fault resets the RG-LRU state: the
#: reference's block_t, the boundary of its first chunk, and a boundary of
#: route "chunk"'s chunks
LRU_RESET_AT = 256


def lru_carry_fault(la, gx, h0):
    """Route "chunk"'s three passes in plain PyTorch with one carried h not
    decayed across its chunk (A_c taken as 1 for the middle chunk)."""
    hloc, decays = rg_lru_chunk_local(la, gx, LRU_CHUNK_LEN)
    decays[:, decays.shape[1] // 2] = 1.0
    starts, _ = rg_lru_chunk_carry(hloc, decays, h0)
    return rg_lru_chunk_outputs(la, gx, starts, LRU_CHUNK_LEN)


def lru_main_check(name, got, want, *inputs):
    """``lru_check``, then planted faults: h0 ignored; beta taken as 1
    (h = a h + gx); the state reset at a chunk boundary; route "chunk"'s
    carried h not decayed across the middle chunk."""
    abs_err, rel_err, extra = lru_check(name, got, want, *inputs)
    la, gx, h0 = as_f32(inputs)
    want32 = rg_lru_scan(la, gx, h0)
    a = torch.exp(la)
    beta = torch.sqrt(torch.clamp(1.0 - a * a, min=0.0))
    c = min(LRU_RESET_AT, la.shape[1] // 2)
    extra["planted_faults"] = scan_faults("rg_lru", {
        "h0_ignored": rg_lru_scan(la, gx, None),
        "beta_one": rg_lru_scan(la, gx / beta, h0),
        "reset_at_chunk_boundary": torch.cat(
            [rg_lru_scan(la[:, :c], gx[:, :c], h0),
             rg_lru_scan(la[:, c:], gx[:, c:], None)], dim=1),
        "carry_not_decayed": lru_carry_fault(la, gx, h0),
    }, want32)
    return abs_err, rel_err, extra


def wkv_work(r, k, v, w, u, s0):
    """r, k, w, v read and the output written once, u, and the state read
    and written once; the fewest flops a step and head: 5 K V (the outer
    product k v^T, the dot of r with S, the decayed update w S + k v^T) and
    3 K + 2 V for the bonus term, which factors as (sum_k r u k) v.  At the
    f32 peak (the state is f32)."""
    b, h, t, dk = r.shape
    dv = v.shape[-1]
    return bound((3 * r.numel() + 2 * v.numel()) * r.element_size()
                 + 4.0 * (u.numel() + 2 * s0.numel()),
                 (5.0 * dk * dv + 3 * dk + 2 * dv) * t * b * h,
                 H100_SXM_FP32_FLOPS)


def lru_work(la, gx, h0):
    """log_a and gx read and h written once, h0 read and the final h
    written; 8 operations an element (exp, a^2, 1 - a^2, max, sqrt,
    beta gx, a h, the sum), at the f32 peak."""
    return bound(3.0 * gx.numel() * gx.element_size() + 8.0 * h0.numel(),
                 8.0 * gx.numel(), H100_SXM_FP32_FLOPS)


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_env(device: torch.device) -> dict:
    t0 = time.perf_counter()
    info = {"phase": "env", "torch": torch.__version__,
            "torch_cuda": torch.version.cuda}
    if device.type == "cuda":
        info["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            check=True, capture_output=True, text=True).stdout.strip()
        nvcc = subprocess.run([_build.find_nvcc(), "--version"], check=True,
                              capture_output=True, text=True).stdout
        info["nvcc"] = nvcc.strip().splitlines()[-2:]
        info["device_name"] = torch.cuda.get_device_name(0)
    info["seconds"] = time.perf_counter() - t0
    emit(info)
    return info


def demangled_name(mangled: str) -> str:
    """The last name of a mangled C++ symbol (``_ZN12_GLOBAL__N_13fooE...``
    gives ``foo``, ``_Z3barv`` gives ``bar``)."""
    pos = 3 if mangled.startswith("_ZN") else 2
    name = mangled
    while (m := re.match(r"\d+", mangled[pos:])):
        pos += len(m.group())
        name = mangled[pos:pos + int(m.group())]
        pos += int(m.group())
    return name


def sass_opcode_counts(text: str) -> dict:
    """``{kernel: {"total": n, opcode: n, ...}}`` from ``cuobjdump -sass``
    output: a static count (a loop body counts once), read against the
    bounds' operation counts.  Template instances get ``#1``, ``#2``."""
    counts, ops = {}, None
    for ln in text.splitlines():
        head = re.search(r"Function : (\S+)", ln)
        if head:
            name = demangled_name(head.group(1))
            seen = sum(k.split("#")[0] == name for k in counts)
            ops = counts.setdefault(f"{name}#{seen}" if seen else name, {})
            continue
        inst = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z]\w*)",
                        ln)
        if inst and ops is not None:
            ops[inst.group(1)] = ops.get(inst.group(1), 0) + 1
    return {fn: {"total": sum(o.values()), **dict(sorted(o.items()))}
            for fn, o in counts.items()}


def sass_text(lib) -> str:
    """``cuobjdump -sass`` of the built library, by the ``cuobjdump`` beside
    ``nvcc``."""
    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    return subprocess.run([cuobjdump, "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout


def sass_instructions(lib) -> dict:
    """Opcode counts of each kernel in the built library."""
    return sass_opcode_counts(sass_text(lib))


#: opcodes that issue on the FP32 pipe
FP32_OPS = ("FADD", "FMUL", "FFMA", "FSETP", "FSEL", "FMNMX", "FCHK")


def loop_slots(text: str, name: str) -> dict:
    """``{mangled name: counts}`` for each instance of kernel ``name`` in
    ``cuobjdump -sass`` output: the instructions of its innermost loop that
    holds a ``MUFU`` (the smallest range from a backward branch's target to
    the branch), by kind, and issue slots a pair, taking one ``MUFU`` (the
    rsqrt) to a pair."""
    bodies, lines = {}, None
    for ln in text.splitlines():
        head = re.search(r"Function : (\S+)", ln)
        if head:
            lines = (bodies.setdefault(head.group(1), [])
                     if demangled_name(head.group(1)) == name else None)
            continue
        inst = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                        r"([A-Z]\w*)(.*)", ln)
        if inst and lines is not None:
            target = re.search(r"0x([0-9a-f]+)", inst.group(3)) \
                if inst.group(2) == "BRA" else None
            lines.append((int(inst.group(1), 16), inst.group(2),
                          int(target.group(1), 16) if target else None))
    out = {}
    for fn, insts in bodies.items():
        loops = [[op for a, op, _ in insts if tgt <= a <= addr]
                 for addr, op, tgt in insts
                 if tgt is not None and tgt <= addr]
        loops = [ops for ops in loops if "MUFU" in ops]
        require(loops, name, "has no loop with a MUFU in its SASS")
        ops = min(loops, key=len)
        pairs = ops.count("MUFU")
        fp32 = sum(op in FP32_OPS for op in ops)
        lds = ops.count("LDS")
        out[fn] = {"pairs": pairs, "slots": len(ops), "fp32": fp32,
                   "mufu": pairs, "lds": lds,
                   "other": len(ops) - fp32 - pairs - lds,
                   "fsetp": ops.count("FSETP"),
                   "slots_per_pair": len(ops) / pairs,
                   "fp32_per_pair": fp32 / pairs, "lds_per_pair": lds / pairs}
    return out


#: the kernels of each route of the multi-route wrappers, by their names in
#: the SASS (a route of several launches names each), and the tensor-core
#: instruction every instance must hold: HGMMA (wgmma) or HMMA (mma.sync);
#: None: neither (the CUDA cores, so routes "pipe", "tri" and "chunk" are
#: true f32)
ROUTE_KERNELS = {
    "gemm_bf16": {"wgmma": (("gemm_wgmma_kernel",), "HGMMA"),
                  "fma": (("gemm_kernel",), None)},
    "gemm": {"pipe": (("gemm_pipe_kernel",), None),
             "fma": (("gemm_kernel",), None)},
    "flash_attention": {"wgmma": (("flash_wgmma_kernel",), "HGMMA"),
                        "fma": (("flash_attention_kernel",), None)},
    "decode_attention": {"mma": (("decode_mma_kernel",), "HMMA"),
                         "fma": (("decode_attention_kernel",), None)},
    "correlate": {"tri": (("correlate_tri_kernel",), None),
                  "fma": (("correlate_kernel",), None)},
    "wkv6": {"chunk": (("wkv6_deltas_kernel", "wkv6_carry_kernel",
                        "wkv6_outputs_kernel"), None),
             "fma": (("wkv6_kernel",), None)},
    "rg_lru": {"chunk": (("rg_lru_local_kernel", "rg_lru_outputs_kernel"),
                         None),
               "fma": (("rg_lru_kernel",), None)},
    "kmeans": {"private": (("kmeans_private_kernel",), None),
               "fma": (("kmeans_kernel",), None)},
    "spmv_ell": {"bin": (("spmv_finite_kernel", "spmv_bin_scatter_kernel",
                          "spmv_bin_gather_kernel"), None),
                 "fma": (("spmv_ell_kernel",), None)},
    "md5": {"unwind": (("md5_unwind_kernel",), None),
            "fma": (("md5_search_kernel",), None)},
    "nbody": {"tile": (("nbody_tile_kernel", "nbody_combine_kernel"), None),
              "fma": (("nbody_kernel",), None)},
}
TENSOR_CORE_OPS = ("HGMMA", "HMMA")
#: instances of the redesigned routes' kernels, whose spills ptxas reports:
#: GEMM wgmma 2 (bf16 and f32 out) and pipe 1, flash attention wgmma 3,
#: decode attention mma 6 (group and head-dim classes), correlator tri 2
#: (f32 and bf16 samples), wkv6 chunk 5 (its first and last passes for f32
#: and bf16, the carry once), rg_lru chunk 4 (both passes for f32 and
#: bf16), kmeans private 4 (one for each f of 2, 4, 8, 16), spmv_ell bin 3
#: (the finite pass, which route "fma" runs too, scatter, gather), md5
#: unwind 1, nbody tile 2 (the sums and the slices' combine)
REDESIGNED_INSTANCES = 33


def tensor_core_counts(sass: dict) -> dict:
    """Tensor-core instructions (HGMMA, HMMA) in each instance of the
    multi-route kernels (a static count): the route's own instruction in
    every instance of a tensor-core route, neither in a CUDA-core one."""
    out = {}
    for row, routes in ROUTE_KERNELS.items():
        out[row] = {}
        for route, (names, op) in routes.items():
            found = {}
            for name in names:
                these = {fn: {o: ops.get(o, 0) for o in TENSOR_CORE_OPS}
                         for fn, ops in sass.items()
                         if fn.split("#")[0] == name}
                require(these, row, "no kernel named", name, "in the SASS")
                found.update(these)
            for fn, n in found.items():
                ok = n[op] > 0 if op else not any(n.values())
                require(ok, row, fn, "holds", n, "tensor-core instructions; "
                        "route", route, "needs", op or "none")
            out[row][route] = found
    return out


#: the kernels of the redesigned routes (every route but "fma")
REDESIGNED_KERNELS = {name for routes in ROUTE_KERNELS.values()
                      for route, (kernels, _) in routes.items()
                      if route != "fma" for name in kernels}


def ptxas_usage(log: str, names=REDESIGNED_KERNELS) -> dict:
    """``{kernel#i: {"spill_bytes": n, "registers": n}}`` for each instance
    of the kernels ``names``, from ptxas' report in the build log (its
    entry line, then its spill stores and loads, then its registers)."""
    usage, name = {}, None
    for ln in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", ln)
        if entry:
            name = demangled_name(entry.group(1))
            name = name if name in names else None
            if name:
                name += f"#{sum(k.split('#')[0] == name for k in usage)}"
                usage[name] = {}
            continue
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                           r"loads", ln)
        regs = re.search(r"Used (\d+) registers", ln)
        if name and spills:
            usage[name]["spill_bytes"] = (int(spills.group(1))
                                          + int(spills.group(2)))
        if name and regs:
            usage[name]["registers"] = int(regs.group(1))
    return usage


def phase_build(device: torch.device) -> dict:
    t0 = time.perf_counter()
    info = {"phase": "build"}
    if device.type == "cuda":
        _build.load()
        info["nvcc_seconds"] = _build.build_seconds
        info["sources"] = [p.name for p in _build.sources()]
        text = sass_text(_build.build())
        info["sass"] = sass_opcode_counts(text)
        info["tensor_cores"] = tensor_core_counts(info["sass"])
        # N-Body's issue slots a pair in each route's inner loop; route
        # "tile"'s rsqrt must be MUFU.RSQ with no test around it.
        slots = {route: loop_slots(text, kernels[0])
                 for route, (kernels, _) in ROUTE_KERNELS["nbody"].items()}
        require(all(len(v) == 1 for v in slots.values()), slots)
        info["nbody_slots_per_pair"] = {r: next(iter(v.values()))
                                        for r, v in slots.items()}
        require(info["nbody_slots_per_pair"]["tile"]["fsetp"] == 0,
                "route tile's rsqrt is guarded:", slots)
        # Registers, shared memory and spills of each kernel, from ptxas.
        log = _build.build_log()
        lines = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
        print("\n".join(lines), file=sys.stderr)
        usage = ptxas_usage(log)
        info["spill_bytes"] = {k: u.get("spill_bytes") for k, u in
                               usage.items()}
        info["registers"] = {k: u.get("registers") for k, u in usage.items()}
        require(len(info["spill_bytes"]) == REDESIGNED_INSTANCES
                and None not in info["spill_bytes"].values(),
                "ptxas reported", info["spill_bytes"], "for the",
                REDESIGNED_INSTANCES, "instances of the redesigned routes")
        require(not any(info["spill_bytes"].values()),
                "a redesigned kernel spills:", info["spill_bytes"])
    else:
        info["skipped"] = "rehearsal on the CPU: nothing to build"
    info["seconds"] = time.perf_counter() - t0
    emit(info)
    return info


def kernel_cases(sizes: Sizes, device: torch.device, gen: torch.Generator):
    """One dict per kernel entry: how to make inputs at the main-path shape
    and at a ragged shape of the reference sweep, the public function, the
    plain version, an optional library call, the tolerance with its
    reason, and the least work the function needs."""
    g = sizes.gemm

    def kmeans_make(n, k, f):
        return kmeans_inputs(n, k, f, gen, device)

    def csums_check(name, got, want, z):
        err = check_close(name, got, want, rtol=1e-4, atol=1e-3)
        mass, total = float(got.double().sum()), float(z.double().sum())
        if abs(mass - total) > 1e-4 * abs(total):
            raise AssertionError(f"{name}: mass {mass} != {total}")
        return err

    def md5_check(name, got, want, n, target, expect, route):
        require(int(got) == int(want) == expect, name, "found", int(got),
                "plain", int(want), "expected", expect)
        return 0.0, 0.0

    def md5_main_check(name, got, want, n, target, expect, route):
        """Kernel and plain version over all n keys, the kernel once more
        with no key matching, and the planted faults of route "unwind"
        (``md5_faults``), each of which must miss the key."""
        md5_check(name, got, want, n, target, expect, route)
        none = int(md5_search(n, MD5_NO_MATCH, device=device))
        require(none == n, name, "no-match search gave", none, "not", n)
        faults = md5_faults(n, target, expect, device) \
            if device.type == "cuda" else []
        return 0.0, 0.0, {"planted_faults": faults}

    def nbody_main_check(name, got, want, posm, softening2):
        """Every target against the f32 plain version within
        ``2e-4 * sum_j |term_ij|`` (two f32 sums of n terms, each held to
        1e-4 of it below), then a slab of targets, kernel and plain
        version both, against float64; then route "tile"'s planted faults
        (``nbody_fault_rows``) at its ragged shape, each of which must fail
        that limit."""
        n, s = posm.shape[0], sizes.nbody_slab
        for lo in range(0, n, s):
            hi = min(n, lo + s)
            err = (got[lo:hi] - want[lo:hi]).abs()
            limit = 2e-4 * nbody_term_scale(posm, lo, hi)
            if not torch.isfinite(got[lo:hi]).all() or (err > limit).any():
                raise AssertionError(
                    f"{name}: targets {lo}:{hi} off the f32 plain version "
                    f"by {float((err / limit).max()):.3e} of the limit")
        lo = (n - s) // 2
        err = nbody_slab_check(name, got[lo:lo + s], want[lo:lo + s], posm,
                               lo, lo + s)
        faults = nbody_fault_rows(nbody_inputs(
            NBODY_RAGGED_TILE, gen, device, zero_every=7)[0])
        return (*err, {"planted_faults": faults,
                       "ordered_floor_ms": nbody_ordered_floor_ms(n)})

    f32, bf16 = torch.float32, torch.bfloat16


    def gemm_case(name, dtype, rate, route):
        return dict(
            name=name, wrapper="gemm", source="src/repro_torch/csrc/gemm.cu",
            replaces="src/repro/kernels/gemm/kernel.py:66",
            main=lambda: gemm_inputs(g, g, g, dtype, gen, device),
            main_route=route,
            # K = 60: 120-byte rows, which TMA refuses (route "fma" in bf16
            # too); (200, 136, 264): aligned, ragged in all three axes
            # (bf16 by "wgmma", f32 by "fma": K not whole 16-deep stages);
            # (200, 144, 260): f32 by "pipe", ragged in M and N
            ragged=lambda: [gemm_inputs(100, 60, 130, dtype, gen, device),
                            gemm_inputs(200, 136, 264, dtype, gen, device),
                            gemm_inputs(200, 144, 260, dtype, gen, device)],
            fn=lambda a, b: gemm(a, b),
            plain=lambda a, b: gemm_ref(a, b),
            library=lambda a, b: torch.matmul(a, b),
            check=gemm_check,
            main_check=gemm_main_check,
            work=lambda a, b: bound(
                (a.numel() + b.numel() + a.shape[0] * b.shape[1])
                * a.element_size(),
                2.0 * a.shape[0] * a.shape[1] * b.shape[1], rate),
            shape=lambda a, b: [a.shape[0], a.shape[1], b.shape[1]],
            first=lambda a, b: gemm_cuda(a, b, route="fma"),
        )

    return [
        # The launch phase's K-Means at (n, f, k) = (2^26, 4, 40) and the
        # stream phase's chunk of 2^22 rows, by route "private" (its first
        # version, route "fma", timed beside it); ragged, (n, k, f): the
        # sweep's (1000, 7, 4) and each other specialised f by "private";
        # by "fma" f = 3 and k (f + 1) past what a thread's accumulators
        # hold ((1000, 50, 4), (2000, 20, 16), (2000, 400, 16)).
        dict(
            name="kmeans", wrapper="kmeans",
            source="src/repro_torch/csrc/kmeans.cu",
            replaces="src/repro/kernels/kmeans/kernel.py:57",
            main=lambda: kmeans_make(sizes.kmeans_n, KM_K, KM_F),
            main_route="private",
            also={"stream_chunk": lambda: kmeans_make(
                sizes.stream_chunk_rows, KM_K, KM_F)},
            ragged=lambda: [kmeans_make(1000, 7, 4), kmeans_make(1000, 7, 3),
                            kmeans_make(5001, 9, 2), kmeans_make(3000, 5, 8),
                            kmeans_make(2000, 6, 16),
                            kmeans_make(1000, 50, 4),
                            kmeans_make(2000, 20, 16),
                            kmeans_make(2000, 400, 16)],
            first=lambda p, c: tuple(x.sum(dim=0) for x in kmeans_cuda(
                p, c, route="fma")),
            fn=lambda p, c: kmeans_assign_reduce(p, c),
            plain=lambda p, c: kmeans_assign_reduce_ref(p, c),
            library=None,
            # counts exact (integers; inputs have separated clusters);
            # sums rtol 1e-4 atol 1e-3: another order of summation.
            check=lambda nm, got, want, *inp: kmeans_check(nm, got, want,
                                                           inp[0]),
            work=lambda p, c: bound(
                (p.numel() + 2 * c.numel() + c.shape[0]) * 4,
                p.shape[0] * (c.shape[0] * (2.0 * p.shape[1] + 3)
                              + 2.0 * p.shape[1]),
                H100_SXM_FP32_FLOPS),
            shape=lambda p, c: [p.shape[0], p.shape[1], c.shape[0]],
        ),
        dict(
            name="hotspot", wrapper="hotspot",
            source="src/repro_torch/csrc/hotspot.cu",
            replaces="src/repro/kernels/stencil2d/kernel.py:69",
            main=lambda: hotspot_inputs(sizes.hotspot, gen, device),
            ragged=lambda: hotspot_inputs((33, 128), gen, device),
            fn=lambda t, p: hotspot_step(t, p),
            plain=lambda t, p: hotspot_step_ref(t, p),
            library=None,
            # rtol 2e-5 atol 2e-4: the reference sweep's, for rounding.
            check=lambda nm, got, want, *inp: check_close(
                nm, got, want, rtol=2e-5, atol=2e-4),
            work=lambda t, p: bound(3 * t.numel() * 4, 15.0 * t.numel(),
                                    H100_SXM_FP32_FLOPS),
            shape=lambda t, p: list(t.shape),
        ),
        dict(
            name="cluster_sums", wrapper="cluster_sums",
            source="src/repro_torch/csrc/cluster_sums.cu",
            replaces="src/repro/kernels/coclustering/kernel.py:51",
            main=lambda: csums_inputs(sizes.csums, gen, device),
            ragged=lambda: csums_inputs((500, 64), gen, device),
            fn=lambda z, ra, ca: cluster_sums(z, ra, ca, CS_R, CS_C),
            plain=lambda z, ra, ca: cluster_sums_ref(z, ra, ca, CS_R, CS_C),
            library=None,
            # rtol 1e-4 atol 1e-3, mass rtol 1e-4: order of summation.
            check=lambda nm, got, want, *inp: csums_check(nm, got, want,
                                                          inp[0]),
            work=lambda z, ra, ca: bound(
                (z.numel() + ra.numel() + ca.numel() + CS_R * CS_C) * 4,
                float(z.numel()), H100_SXM_FP32_FLOPS),
            shape=lambda z, ra, ca: list(z.shape),
        ),
        # f32: true f32 products on the CUDA cores, loads a stage ahead;
        # bf16: the tensor cores; each with its first version (route "fma")
        # timed beside it (GEMM_TOL).
        gemm_case("gemm", torch.float32, H100_SXM_FP32_FLOPS, "pipe"),
        gemm_case("gemm_bf16", torch.bfloat16, H100_SXM_BF16_FLOPS, "wgmma"),
        dict(
            name="black_scholes", wrapper="black_scholes",
            source="src/repro_torch/csrc/black_scholes.cu",
            replaces="src/repro/kernels/black_scholes/kernel.py:56",
            main=lambda: bs_inputs(sizes.bs_n, gen, device),
            # 1000 (16-byte path only), 1003 (scalar tail) and a view one
            # element in (not 16-byte aligned: scalar path throughout)
            ragged=lambda: [bs_inputs(1000, gen, device),
                            bs_inputs(1003, gen, device),
                            tuple(t[1:] for t in bs_inputs(1002, gen, device))],
            fn=lambda s, k, t: black_scholes(s, k, t),
            plain=lambda s, k, t: black_scholes_ref(s, k, t),
            library=None,
            check=lambda nm, got, want, *inp: bs_check(nm, got, want, *inp),
            # 20 bytes an option; 27 operations an option counting sqrtf,
            # logf, erff (x2) and expf as one each, 22 adds, multiplies
            # and divides besides.
            work=lambda s, k, t: bound(20.0 * s.numel(), 27.0 * s.numel(),
                                       H100_SXM_FP32_FLOPS),
            shape=lambda s, k, t: [s.numel()],
        ),
        # The launch phase's SpMV, (2^25, 16) with x of 2^25 columns (128
        # MiB, past L2), by route "bin" (its first version, route "fma",
        # timed beside it); ragged: 300 rows by "fma" (16 entries a row:
        # 16-byte loads, 4 lanes a row; 13: single loads, 16 lanes), and
        # a ragged shape by "bin" with columns out of range, without and
        # with NaN in x under zero entries.
        dict(
            name="spmv_ell", wrapper="spmv_ell",
            source="src/repro_torch/csrc/spmv_ell.cu",
            replaces="src/repro/kernels/spmv_ell/kernel.py:43",
            main=lambda: spmv_inputs(sizes.spmv[0], sizes.spmv[1],
                                     sizes.spmv[0], gen, device),
            main_route="bin",
            ragged=lambda: [spmv_ragged_inputs(16, gen, device),
                            spmv_ragged_inputs(13, gen, device),
                            spmv_bin_inputs(sizes.spmv_bin_ragged, gen,
                                            device),
                            spmv_bin_inputs(sizes.spmv_bin_ragged, gen,
                                            device, nan_under_zeros=True)],
            first=lambda d, c, x: spmv_ell_cuda(d, c, x, route="fma"),
            fn=lambda d, c, x: spmv_ell(d, c, x),
            plain=lambda d, c, x: spmv_ell_ref(d, c, x),
            library=lambda csr, x: torch.mv(csr, x),
            library_setup=ell_to_csr,
            check=spmv_check,
            main_check=lambda nm, got, want, *inp: (
                *spmv_check(nm, got, want),
                {"planted_faults": spmv_bin_faults(sizes.spmv_bin_ragged,
                                                   gen, device)}),
            # data, cols and y once, x once; the random gather reads a
            # 32-byte sector per entry, so the real traffic is larger.
            work=lambda d, c, x: bound(
                (d.numel() + c.numel() + d.shape[0] + x.numel()) * 4.0,
                2.0 * d.numel(), H100_SXM_FP32_FLOPS),
            shape=lambda d, c, x: [d.shape[0], d.shape[1], x.numel()],
        ),
        # The launch phase's two searches of 2^30 keys, by route "unwind"
        # (its first version, route "fma", timed beside it); ragged: n =
        # 2048 with the key at 0, at 1500 and nowhere, by "unwind" and by
        # "fma".  An input is (n, target, expected index, route named).
        dict(
            name="md5", wrapper="md5",
            source="src/repro_torch/csrc/md5.cu",
            replaces="src/repro/kernels/md5/kernel.py:52",
            main=lambda: (sizes.md5_n,
                          md5_digest(sizes.md5_n - MD5_PLANT_BELOW_N),
                          sizes.md5_n - MD5_PLANT_BELOW_N, None),
            main_route="unwind",
            ragged=lambda: [(2048, md5_digest(0), 0, None),
                            (2048, md5_digest(1500), 1500, None),
                            (2048, MD5_NO_MATCH, 2048, None),
                            (2048, md5_digest(1500), 1500, "fma"),
                            (2048, MD5_NO_MATCH, 2048, "fma")],
            first=lambda n, t, e, r: md5_search_cuda(n, t, device,
                                                     route="fma"),
            fn=lambda n, t, e, r: (
                md5_search(n, t, device=device)
                if r is None or device.type != "cuda"
                else md5_search_cuda(n, t, device, route=r)[0]),
            plain=lambda n, t, e, r: md5_search_ref(n, t, device=device),
            plain_reps=1,
            library=None,
            # exact: an index
            check=md5_check,
            main_check=md5_main_check,
            # every key runs rounds 1-52 (no early exit), 16 bytes of
            # target read, one int written
            work=lambda n, t, e, r: md5_work(n),
            shape=lambda n, t, e, r: [n],
        ),
        # The launch phase's 2^17 bodies by route "tile" (its first
        # version, route "fma", timed beside it); ragged: n = 300 by "fma",
        # a last source tile of 37 bodies with every 7th mass zero by
        # "tile", and eps^2 = 0 by "fma" (NaN wherever the plain version
        # has it).  An input is (posm, eps^2).
        dict(
            name="nbody", wrapper="nbody",
            source="src/repro_torch/csrc/nbody.cu",
            replaces="src/repro/kernels/nbody/kernel.py:64",
            main=lambda: nbody_inputs(sizes.nbody_n, gen, device),
            main_route="tile",
            ragged=lambda: [nbody_inputs(300, gen, device),
                            nbody_inputs(NBODY_RAGGED_TILE, gen, device,
                                         zero_every=7),
                            nbody_inputs(300, gen, device, softening2=0.0)],
            first=lambda p, e: nbody_cuda(p, softening2=e, route="fma"),
            fn=lambda p, e: nbody_forces(p, softening2=e),
            plain=lambda p, e: nbody_forces_ref(p, e),
            plain_reps=1,
            library=None,
            # 1e-4 of sum |term| against float64 (nbody_check; the main
            # shape by nbody_main_check).
            check=nbody_check,
            main_check=nbody_main_check,
            work=lambda p, e: bound(
                p.shape[0] * 28.0,
                float(p.shape[0]) ** 2 * NBODY_FLOPS_PER_PAIR,
                H100_SXM_FP32_FLOPS),
            shape=lambda p, e: [p.shape[0]],
        ),
        # The serving path's prefill at phi3-mini's width, causal, bf16;
        # gemma-2b's MQA (8 query heads on one kv head of 256 dims) held
        # and timed beside it (not a shape of the serving path: no
        # launches of its own), and the serving shapes of granite-moe-3b
        # (causal, a group of 3) and whisper-medium (its encoder and its
        # decoder's cross-attention, non-causal, T = 1500 a multiple of no
        # tile); ragged and f32 cases of the reference sweep.
        dict(
            name="flash_attention", wrapper="flash_attention",
            source="src/repro_torch/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention/kernel.py:110",
            main=lambda: flash_inputs(sizes.flash, bf16, gen, device),
            main_route="wgmma",
            also={"gemma": lambda: flash_inputs(sizes.flash_gemma, bf16,
                                                gen, device),
                  "granite": lambda: flash_inputs(sizes.flash_granite, bf16,
                                                  gen, device),
                  "whisper_encoder": lambda: flash_inputs(
                      sizes.flash_whisper_encoder, bf16, gen, device,
                      causal=False),
                  "whisper_cross": lambda: flash_inputs(
                      sizes.flash_whisper_cross, bf16, gen, device,
                      t=sizes.whisper_frames, causal=False),
                  "phi3_tp_rank": lambda: flash_inputs(sizes.tp_flash, bf16,
                                                       gen, device),
                  "granite_tp_rank": lambda: flash_inputs(
                      sizes.tp_flash_granite, bf16, gen, device),
                  "whisper_tp_rank_encoder": lambda: flash_inputs(
                      sizes.tp_flash_whisper_encoder, bf16, gen, device,
                      causal=False),
                  "whisper_tp_rank_self": lambda: flash_inputs(
                      sizes.tp_flash_whisper_self, bf16, gen, device),
                  "whisper_tp_rank_cross": lambda: flash_inputs(
                      sizes.tp_flash_whisper_self, bf16, gen, device,
                      t=sizes.tp_flash_whisper_encoder[3], causal=False)},
            # the planted faults are causal with S = T: the non-causal
            # shapes are held to the bf16 limit alone
            also_check={"whisper_encoder": flash_check,
                        "whisper_cross": flash_check,
                        "whisper_tp_rank_encoder": flash_check,
                        "whisper_tp_rank_cross": flash_check},
            # f32 (route "fma") and bf16 (route "wgmma": the TMA boxes'
            # zero fill at ragged S and T, D = 96 and 256, the masks)
            ragged=lambda: [
                flash_inputs((1, 8, 2, 256, 64), f32, gen, device),  # GQA
                flash_inputs((1, 4, 1, 128, 32), f32, gen, device,
                             window=64),  # sliding window
                flash_inputs((2, 4, 2, 100, 32), f32, gen, device),  # S=100
                flash_inputs((1, 4, 2, 40, 32), f32, gen, device, t=100,
                             q_offset=60),  # q_offset > 0, S < T, ragged T
                flash_inputs((1, 4, 4, 128, 64), bf16, gen, device),
                flash_inputs((1, 8, 1, 130, 256), f32, gen, device),  # MQA
                flash_inputs((1, 8, 2, 100, 96), bf16, gen, device),
                flash_inputs((1, 10, 1, 300, 256), bf16, gen, device,
                             window=64),
                flash_inputs((1, 4, 2, 40, 96), bf16, gen, device, t=100,
                             q_offset=60),
                # non-causal, S < T, T a multiple of no tile, a group of 3
                flash_inputs((1, 6, 2, 50, 32), f32, gen, device, t=130,
                             causal=False),
                flash_inputs((1, 6, 2, 100, 64), bf16, gen, device, t=300,
                             causal=False),
            ],
            first=lambda q, k, v, kw: flash_attention_cuda(
                q, k, v, route="fma", **kw),
            fn=lambda q, k, v, kw: flash_attention(q, k, v, **kw),
            plain=lambda q, k, v, kw: attention_ref(q, k, v, **kw),
            library=lambda q, k, v, kw: F.scaled_dot_product_attention(
                q, k, v, is_causal=kw.get("causal", True), enable_gqa=True),
            check=flash_check,
            main_check=flash_main_check,
            work=flash_work,
            queued=KERNEL_HOST_S,
            shape=lambda q, k, v, kw: [q.shape[0], q.shape[1], k.shape[1],
                                       q.shape[2], k.shape[2], q.shape[3]],
        ),
        # The serving paths' decode steps: phi3-mini's (8 slots, kv_len
        # over [1, T]), recurrentgemma-2b's ring buffer (10 query heads
        # on one kv head of 256), granite-moe-3b's (a group of 3, kv_len
        # over [1, T]) and whisper-medium's cross-attention (kv_len the
        # 1500 frames); gemma-2b's MQA beside them, as for flash
        # attention.  bf16 takes the tensor cores (route "mma"), its first
        # version (route "fma") timed beside it.
        dict(
            name="decode_attention", wrapper="decode_attention",
            source="src/repro_torch/csrc/decode_attention.cu",
            replaces="src/repro/kernels/decode_attention/kernel.py:94",
            main=lambda: decode_inputs(sizes.decode, bf16, gen, device),
            main_route="mma",
            also={"gemma": lambda: decode_inputs(sizes.decode_gemma, bf16,
                                                 gen, device),
                  "recurrentgemma": lambda: decode_inputs(
                      sizes.decode_rgemma, bf16, gen, device),
                  "granite": lambda: decode_inputs(sizes.decode_granite, bf16,
                                                   gen, device),
                  "whisper_cross": lambda: decode_inputs(
                      sizes.decode_whisper_cross, bf16, gen, device,
                      kv_len=sizes.decode_whisper_cross[3]),
                  "phi3_tp_rank": lambda: decode_inputs(sizes.tp_decode,
                                                        bf16, gen, device),
                  "granite_tp_rank": lambda: decode_inputs(
                      sizes.tp_decode_granite, bf16, gen, device),
                  "whisper_tp_rank_self": lambda: decode_inputs(
                      sizes.tp_decode_whisper_self, bf16, gen, device),
                  "gemma_seq_rank": lambda: decode_inputs(
                      sizes.tp_decode_gemma_seq, bf16, gen, device),
                  "whisper_tp_rank_cross": lambda: decode_inputs(
                      sizes.tp_decode_whisper_cross, bf16, gen, device,
                      kv_len=sizes.tp_decode_whisper_cross[3])},
            # f32 (route "fma") and bf16 (route "mma": T ragged, G = 10 and
            # 32 query heads a kv head, rows at kv_len 1 and T)
            ragged=lambda: [
                decode_inputs((2, 8, 2, 512, 64), f32, gen, device),
                decode_inputs((1, 4, 4, 300, 32), f32, gen, device,
                              kv_len=1),
                decode_inputs((2, 4, 1, 256, 64), f32, gen, device),
                decode_inputs((8, 32, 32, 300, 96), bf16, gen, device),
                decode_inputs((2, 8, 1, 300, 256), f32, gen, device),
                decode_inputs((3, 10, 1, 300, 256), bf16, gen, device),
                decode_inputs((2, 32, 1, 200, 128), bf16, gen, device),
            ],
            first=lambda q, k, v, n: decode_attention_cuda(
                q, k, v, n, route="fma"),
            fn=lambda q, k, v, n: decode_attention(q, k, v, kv_len=n,
                                                   with_lse=True),
            plain=lambda q, k, v, n: decode_attention_ref(
                q, k, v, kv_len=n, with_lse=True),
            library=lambda q4, k, v, m: F.scaled_dot_product_attention(
                q4, k, v, attn_mask=m, enable_gqa=True),
            library_setup=sdpa_decode_setup,
            check=decode_check,
            main_check=decode_main_check,
            work=decode_work,
            queued=KERNEL_HOST_S,
            shape=lambda q, k, v, n: [q.shape[0], q.shape[1], k.shape[1],
                                      k.shape[2], q.shape[2]],
        ),
        # The paper's correlator at (C, T, A) = (1024, 768, 256) f32, the
        # size of the launch phase, by route "tri" (the tiles with i <= j,
        # the rest mirrored), its first version (route "fma") timed beside
        # it; ragged T and A, and the sweep's shapes: A <= 64 by "fma", A =
        # 200 (rows 16-byte aligned) and 65 (a last tile of one antenna,
        # rows not aligned) by "tri", in f32 and bf16.
        dict(
            name="correlate", wrapper="correlate",
            source="src/repro_torch/csrc/correlator.cu",
            replaces="src/repro/kernels/correlator/kernel.py:62",
            main=lambda: corr_inputs(*sizes.corr, gen, device),
            main_route="tri",
            ragged=lambda: [corr_inputs(3, 77, 37, gen, device),
                            corr_inputs(2, 513, 64, gen, device),
                            corr_inputs(4, 100, 16, gen, device),
                            corr_inputs(3, 77, 37, gen, device, bf16),
                            corr_inputs(3, 77, 200, gen, device),
                            corr_inputs(3, 77, 200, gen, device, bf16),
                            corr_inputs(2, 33, 65, gen, device),
                            corr_inputs(2, 33, 65, gen, device, bf16)],
            first=lambda x: correlate_cuda(x, route="fma"),
            fn=lambda x: correlate(x),
            plain=lambda x: correlate_ref(x),
            library=lambda x: torch.matmul(x.mT, x.conj()),
            library_setup=corr_setup,
            check=corr_check,
            main_check=corr_main_check,
            work=corr_work,
            shape=lambda x: list(x.shape[:3]),
        ),
        # rwkv6-3b's prefill of 2048 tokens, bf16, by route "chunk" (its
        # first version, route "fma", timed beside it), and its 8-slot
        # decode step beside it by "fma"; ragged T, K and V in f32 and
        # bf16: T under two chunks by "fma"; by "chunk" T not a multiple
        # of the chunk (300, 161), V = 50, K = 20 (staged a channel at a
        # time) and decays of exactly 0 and 1.
        dict(
            name="wkv6", wrapper="wkv6",
            source="src/repro_torch/csrc/wkv6.cu",
            replaces="src/repro/kernels/rwkv6/kernel.py:75",
            main=lambda: wkv_inputs(*sizes.wkv, sizes.wkv[-1], bf16, gen,
                                    device),
            main_route="chunk",
            also={"decode": lambda: wkv_inputs(*sizes.wkv_decode,
                                               sizes.wkv_decode[-1], bf16,
                                               gen, device),
                  "tp_rank": lambda: wkv_inputs(*sizes.tp_wkv,
                                                sizes.tp_wkv[-1], bf16, gen,
                                                device),
                  "tp_rank_decode": lambda: wkv_inputs(
                      *sizes.tp_wkv_decode, sizes.tp_wkv_decode[-1], bf16,
                      gen, device)},
            also_route={"decode": "fma", "tp_rank": "chunk",
                        "tp_rank_decode": "fma"},
            also_check=wkv_check,
            ragged=lambda: [wkv_inputs(2, 3, 45, 16, 8, f32, gen, device),
                            wkv_inputs(1, 4, 70, 64, 64, f32, gen, device),
                            wkv_inputs(2, 2, 33, 20, 50, bf16, gen, device),
                            wkv_inputs(1, 4, 300, 64, 64, f32, gen, device),
                            wkv_inputs(1, 4, 300, 64, 64, bf16, gen, device),
                            wkv_inputs(2, 3, 161, 64, 50, f32, gen, device),
                            wkv_inputs(2, 3, 161, 64, 50, bf16, gen, device),
                            wkv_inputs(2, 2, 200, 20, 50, f32, gen, device),
                            wkv_exact_decays(wkv_inputs(1, 4, 300, 64, 64,
                                                        f32, gen, device))],
            first=lambda r, k, v, w, u, s0: wkv6_cuda(r, k, v, w, u, s0,
                                                      route="fma"),
            fn=lambda r, k, v, w, u, s0: wkv6(r, k, v, w, u, s0,
                                              return_state=True),
            plain=lambda r, k, v, w, u, s0: wkv6_ref(r, k, v, w, u, s0,
                                                     return_state=True),
            library=None,
            check=wkv_check,
            main_check=wkv_main_check,
            work=wkv_work,
            queued=KERNEL_HOST_S,
            shape=lambda r, k, v, w, u, s0: [*r.shape, v.shape[-1]],
        ),
        # recurrentgemma-2b's prefill of 2048 tokens, bf16, by route "chunk"
        # (its first version, route "fma", timed beside it), and its 8-slot
        # decode step beside it by "fma"; ragged T and D in f32 and bf16:
        # T under three chunks (the sweep's, and 161 at full width) by
        # "fma"; by "chunk" T not a multiple of the chunk (300, 4170),
        # D = 100, log_a of exactly 0 (a = 1) and -50 (a underflows in a
        # chunk's product), and T = 4170 (over 64 chunks of 64: 64 chunks
        # of 66 instead).
        dict(
            name="rg_lru", wrapper="rg_lru",
            source="src/repro_torch/csrc/rg_lru.cu",
            replaces="src/repro/kernels/rg_lru/kernel.py:69",
            main=lambda: lru_inputs(*sizes.lru, bf16, gen, device),
            main_route="chunk",
            also={"decode": lambda: lru_inputs(*sizes.lru_decode, bf16, gen,
                                               device),
                  "tp_rank": lambda: lru_inputs(*sizes.tp_lru, bf16, gen,
                                                device),
                  "tp_rank_decode": lambda: lru_inputs(
                      *sizes.tp_lru_decode, bf16, gen, device)},
            also_route={"decode": "fma", "tp_rank": "chunk",
                        "tp_rank_decode": "fma"},
            also_check=lru_check,
            ragged=lambda: [lru_inputs(2, 50, 100, f32, gen, device,
                                       sweep=True),
                            lru_inputs(2, 96, 256, f32, gen, device),
                            lru_inputs(3, 37, 70, bf16, gen, device),
                            lru_inputs(2, 300, 100, f32, gen, device),
                            lru_inputs(2, 300, 100, bf16, gen, device),
                            lru_inputs(3, 161, 2560, bf16, gen, device),
                            lru_exact_decays(lru_inputs(2, 300, 100, f32,
                                                        gen, device)),
                            lru_exact_decays(lru_inputs(2, 300, 100, bf16,
                                                        gen, device)),
                            lru_inputs(1, 4170, 100, f32, gen, device)],
            first=lambda la, gx, h0: rg_lru_cuda(la, gx, h0, route="fma"),
            fn=lambda la, gx, h0: rg_lru(la, gx, h0, return_state=True),
            plain=lru_plain,
            library=None,
            check=lru_check,
            main_check=lru_main_check,
            work=lru_work,
            queued=KERNEL_HOST_S,
            shape=lambda la, gx, h0: list(gx.shape),
        ),
    ]


def routed(wrapper, fn, device):
    """``fn()`` and the route its one launch took, by the wrapper's
    ``routes`` counts (None for a one-route wrapper or on the CPU)."""
    before = dict(getattr(wrapper, "routes", {}))
    out = fn()
    taken = [r for r, n in getattr(wrapper, "routes", {}).items()
             if n != before[r]]
    require(len(taken) <= 1, "one call took routes", taken)
    return out, (taken[0] if taken and device.type == "cuda" else None)


def measure(case: dict, inputs, sizes: Sizes, device: torch.device,
            check=None, route_wanted=None) -> dict:
    """One shape of a kernel: its result held against the plain version
    (``check``, else ``main_check``, else ``check`` of the case), then the
    kernel, the plain version and the library call timed, and the bound of
    the work, and for a two-route kernel the route it took (which must be
    ``route_wanted``, else the case's ``main_route``) and, where that is
    not the first version, the first version's time on the same inputs."""
    wrapper = WRAPPERS[case["wrapper"]]
    got, route = routed(wrapper, lambda: case["fn"](*inputs), device)
    route_wanted = route_wanted or case.get("main_route")
    if route_wanted and device.type == "cuda":
        require(route == route_wanted, case["name"], "took route",
                route, "not", route_wanted)
    sync(device)
    plain_reps = case.get("plain_reps", sizes.reps)
    plain_ms = None
    if plain_reps == 1:
        # A plain version that takes seconds runs once, timed, and that run
        # is the one the kernel is held against.
        kept = []
        plain_ms = time_ms(lambda: kept.append(case["plain"](*inputs)),
                           device, 1, warmup=False)
        want = kept.pop()
    else:
        want = case["plain"](*inputs)
    check = check or case.get("main_check", case["check"])
    abs_err, rel_err, *extra = check(
        f"{case['name']}/{list(case['shape'](*inputs))}", got, want, *inputs)
    first = want[0] if isinstance(want, tuple) else want
    require(float(first.abs().max()) > 0, case["name"], "compared all zeros")
    del got, want, first
    queued = case.get("queued", 0.0)
    if plain_reps > 1:
        plain_ms = time_ms(lambda: case["plain"](*inputs), device,
                           plain_reps, queued=queued)
    bound_ms, bound_by = case["work"](*inputs)
    library_ms = None
    if case["library"]:
        lib_inputs = case.get("library_setup", lambda *a: a)(*inputs)
        library_ms = time_ms(lambda: case["library"](*lib_inputs),
                             device, sizes.reps, queued=queued)
        del lib_inputs
    first = {}
    if case.get("first") and route_wanted != "fma" and device.type == "cuda":
        first = {"first_version_route": "fma", "first_version_ms": time_ms(
            lambda: case["first"](*inputs), device, sizes.reps,
            queued=queued)}
    return {
        "max_abs_err": abs_err, "max_rel_err": rel_err,
        **({"kernel_route": route} if route else {}), **first,
        "ms": time_ms(lambda: case["fn"](*inputs), device, sizes.reps,
                      queued=queued),
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms, "shape": case["shape"](*inputs),
        **(extra[0] if extra else {}),
    }


def phase_kernels(sizes: Sizes, device: torch.device,
                  gen: torch.Generator, build: dict) -> list[dict]:
    """Each kernel against its plain version on the card, at ragged shapes,
    then at the main-path shape (and at the shapes in ``also``), where it is
    also timed.  A two-route kernel's ragged cases must take route "fma"
    at least once, and its row carries the HGMMA counts of ``build``."""
    t0 = time.perf_counter()
    # The plain versions multiply in true f32, like the kernels.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = []
    for case in kernel_cases(sizes, device, gen):
        name = case["name"]
        wrapper = WRAPPERS[case["wrapper"]]
        raggeds = case["ragged"]()
        if not isinstance(raggeds, list):
            raggeds = [raggeds]
        ragged_err, ragged_routes = 0.0, []
        for inputs in raggeds:
            before = wrapper.launches
            got, route = routed(wrapper, lambda: case["fn"](*inputs), device)
            sync(device)
            if device.type == "cuda" and wrapper.launches != before + 1:
                raise AssertionError(f"{name}: the wrapper did not launch")
            ragged_routes.append(route)
            ragged_err = max(ragged_err, case["check"](
                f"{name}/ragged", got, case["plain"](*inputs), *inputs)[0])
        ragged_shape = case["shape"](*raggeds[0])
        del raggeds, inputs, got
        if case.get("main_route") and device.type == "cuda":
            require({"fma", case["main_route"]} <= set(ragged_routes), name,
                    "ragged cases took only", ragged_routes)

        row = {"name": name, "route": "cuda", "source": case["source"],
               "replaces": case["replaces"], "launches": None,
               **measure(case, case["main"](), sizes, device),
               "ragged_shape": ragged_shape,
               "ragged_max_abs_err": ragged_err,
               **({"ragged_routes": ragged_routes}
                  if any(ragged_routes) else {}),
               **({"tensor_cores": build["tensor_cores"][name]}
                  if name in build.get("tensor_cores", {}) else {})}
        for label, make in case.get("also", {}).items():
            check = case.get("also_check")
            if isinstance(check, dict):
                check = check.get(label)
            row[label] = measure(case, make(), sizes, device, check,
                                 case.get("also_route", {}).get(label))
        if case.get("plain_reps", sizes.reps) != sizes.reps:
            row["plain_runs"] = case["plain_reps"]
        if case.get("queued"):
            row["timing"] = (f"mean of {sizes.reps} back-to-back calls "
                             "queued behind a device sleep: device time")
        rows.append(row)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    emit({"phase": "kernels", "tf32": False, "rows": rows,
          "seconds": time.perf_counter() - t0})
    return rows


#: workers of the launch phase's mesh pass, all on the one GPU
MESH_WORKERS = 4


def halo_stencil_body(views, info):
    """The 1-D stencil on a view with a cell of each neighbour on either
    side (zeros at the two end shards); the whole array (one worker) gets
    the same zeros.  Sums in the launch phase's order: (left + x) + right."""
    x = views["input"]
    if x.shape[0] == info.grid[0]:
        zero = torch.zeros((1,), dtype=x.dtype, device=x.device)
        x = torch.cat([zero, x, zero])
    return {"output": (x[:-2] + x[1:-1] + x[2:]) / 3.0}


def halo_hotspot_body(views, info):
    """One HotSpot step on a worker's slab: the halo row at either end of
    the grid (zeros) is dropped so that the kernel's own clamp applies
    there, the neighbours' rows are kept for the stencil and their outputs
    dropped; power (LOCAL) is padded to the slab.  On one worker the slab
    is the whole grid."""
    slab, power = views["temp"], views["power"]
    if slab.shape[0] == info.grid[0]:
        return {"out": hotspot_step(slab, power)}
    top = info.thread_offset[0] == 0
    bottom = info.thread_offset[0] + info.local_shape[0] == info.grid[0]
    slab = slab[int(top): slab.shape[0] - int(bottom)]
    pad = power.new_zeros((1, power.shape[1]))
    power = torch.cat([pad] * (not top) + [power] + [pad] * (not bottom))
    out = hotspot_step(slab.contiguous(), power)
    return {"out": out[int(not top): out.shape[0] - int(not bottom)]}


def kmeans_body(views, info):
    sums, counts = kmeans_assign_reduce(views["points"], views["centroids"])
    return {"sums": sums, "counts": counts}


def md5_prefix_body(views, info):
    """MD5 on a worker: the kernel searches from key 0, so the worker
    searches up to the end of its range, and its own no-match (the end)
    becomes the grid's n; the smallest over the workers is the smallest
    overall.  On one worker, the whole grid."""
    n = info.grid[0]
    end = info.thread_offset[0] + info.local_shape[0]
    found = md5_search(end, info.scalars["target"],
                       device=views["found"].device).reshape(1)
    return {"found": torch.where(found == end, n, found)}


def phase_launch(sizes: Sizes, device: torch.device,
                 gen: torch.Generator, store: str | None = None) -> dict:
    """The annotated-kernel launch path: every body calls the port's public
    wrapper, every launch goes through the planner and ``Context.launch``."""
    t0 = time.perf_counter()
    on_card = device.type == "cuda"
    ctx = Context(device=device)
    out = {"phase": "launch"}

    def launched(wrapper_name: str, since: int, expect: int) -> int:
        n = WRAPPERS[wrapper_name].launches - since
        if on_card and n != expect:
            raise AssertionError(
                f"{wrapper_name}: {n} kernel launches, expected {expect}")
        return n

    # (a) the quickstart 1-D stencil, ten launches with buffer swap.
    stencil = KernelDef.define(
        "stencil", halo_stencil_body,
        "global i => read input[i-1:i+1], write output[i]")
    n = sizes.stencil_n
    t1 = time.perf_counter()
    x0 = torch.rand((n,), generator=gen, device=device)
    a = ctx.array(x0, dist=StencilDist(n // 8, 1), name="input")
    b = ctx.zeros((n,), dist=StencilDist(n // 8, 1), name="output")
    first = len(ctx.records)
    for _ in range(10):
        res = ctx.launch(stencil, grid=(n,), work_dist=BlockWork(n // 8),
                         args={"input": a, "output": b})
        a, b = res["output"], a
    ctx.synchronize(a)
    prefix = 1024  # ten steps of a prefix depend on ten more cells
    want = x0[: prefix + 10].cpu().numpy().astype(np.float32)
    for _ in range(10):
        pad = np.pad(want, 1)
        want = ((pad[:-2] + pad[1:-1] + pad[2:]) / np.float32(3.0)
                ).astype(np.float32)
    np.testing.assert_allclose(a.to_numpy()[:prefix], want[:prefix],
                               rtol=1e-5, atol=1e-6)
    require(len(ctx.records) - first == 10)
    comm = {k: v.value for k, v in ctx.records[-1].comm.items()}
    require(comm == {"input": "halo", "output": "local"}, comm)
    out["stencil"] = {"n": n, "launches": 10, "comm": comm,
                      "seconds": time.perf_counter() - t1}
    del x0, a, b, res

    # (b) HotSpot with a one-cell halo in both axes.
    hotspot = KernelDef.define(
        "hotspot", halo_hotspot_body,
        "global [i, j] => read temp[i-1:i+1, j-1:j+1], read power[i,j], "
        "write out[i,j]")
    rows, cols = sizes.hotspot
    t1 = time.perf_counter()
    temp0, power0 = hotspot_inputs((rows, cols), gen, device)
    slab = max(1, rows // 8)
    temp = ctx.array(temp0, dist=StencilDist(slab, 1), name="temp")
    power = ctx.array(power0, dist=BlockDist(slab), name="power")
    nxt = ctx.zeros((rows, cols), dist=StencilDist(slab, 1), name="out")
    since = hotspot_cuda.launches
    for _ in range(sizes.hotspot_steps):
        res = ctx.launch(hotspot, grid=(rows, cols),
                         work_dist=BlockWork(slab),
                         args={"temp": temp, "power": power, "out": nxt})
        temp, nxt = res["out"], temp  # swap, like the paper's host loop
    ctx.synchronize(temp)
    want = temp0
    for _ in range(sizes.hotspot_steps):
        want = hotspot_step_ref(want, power0)
    err = check_close("launch/hotspot", temp.value, want, rtol=2e-5,
                      atol=2e-4)
    require(ctx.records[-1].comm["temp"].value == "halo")
    out["hotspot"] = {
        "shape": [rows, cols], "steps": sizes.hotspot_steps,
        "kernel_launches": launched("hotspot", since, sizes.hotspot_steps),
        "max_abs_err": err[0], "seconds": time.perf_counter() - t1}
    del temp0, power0, temp, power, nxt, want, res

    # (c) K-Means with reduce(+) on sums and counts.
    kmeans = KernelDef.define(
        "kmeans", kmeans_body,
        "global i => read points[i,:], read centroids[:,:], "
        "reduce(+) sums[:,:], reduce(+) counts[:]")
    n = sizes.kmeans_n
    t1 = time.perf_counter()
    centers = lattice_centers(gen, device)
    pts = clustered_points(n, centers, gen)
    cen0 = start_centroids(centers, gen)
    points = ctx.array(pts, dist=RowDist(8), name="points")
    sums = ctx.zeros((KM_K, KM_F), dist=ReplicatedDist(), name="sums")
    counts = ctx.zeros((KM_K,), dist=ReplicatedDist(), name="counts")
    sample = pts[:: max(1, n // (1 << 20))]  # inertia on a stated subsample

    def inertia(c):
        d2 = torch.cdist(sample.double(), c.double()) ** 2
        return float(d2.min(dim=1).values.sum())

    since = kmeans_cuda.launches
    private_since = kmeans_cuda.routes["private"]
    cen, prev, trace = cen0, inertia(cen0), []
    for _ in range(sizes.kmeans_iters):
        res = ctx.launch(
            kmeans, grid=(n,), work_dist=BlockWork(max(1, n // 8)),
            args={"points": points,
                  "centroids": ctx.array(cen, name="centroids"),
                  "sums": sums, "counts": counts})
        cnt = res["counts"].value
        require(float(cnt.double().sum()) == float(n),
                "counts must sum to n")
        cen = res["sums"].value / cnt.clamp(min=1.0)[:, None]
        cur = inertia(cen)
        require(cur <= prev * 1.001, "inertia rose", prev, cur)
        prev = cur
        trace.append(cur)
    ctx.synchronize()
    comm = {k: v.value for k, v in ctx.records[-1].comm.items()}
    require(comm["sums"] == "reduce" and comm["counts"] == "reduce", comm)
    n_launched = launched("kmeans", since, sizes.kmeans_iters)
    by_private = kmeans_cuda.routes["private"] - private_since
    if on_card:
        require(by_private == n_launched, "kmeans took route private",
                by_private, "of", n_launched, "times")
    want = cen0
    for _ in range(sizes.kmeans_iters):
        s, c = kmeans_assign_reduce_ref(pts, want)
        want = s / c.clamp(min=1.0)[:, None]
    require(torch.equal(c, cnt), "final counts differ from the plain version")
    err = check_close("launch/kmeans", cen, want, rtol=1e-4, atol=1e-3)
    out["kmeans"] = {
        "n": n, "f": KM_F, "k": KM_K, "iterations": sizes.kmeans_iters,
        "kernel_launches": n_launched, "by_route_private": by_private,
        "inertia_on_sample": trace,
        "max_abs_err": err[0], "seconds": time.perf_counter() - t1}
    del pts, points, sample, res, want, s, c, cnt, cen

    # (d) co-clustering cluster sums with reduce(+).
    def csums_body(v, info):
        return {"cc": cluster_sums(v["z"], v["row_assign"], v["col_assign"],
                                   CS_R, CS_C)}

    csums = KernelDef.define(
        "cluster_sums", csums_body,
        "global [i, j] => read z[i,j], read row_assign[i], "
        "read col_assign[j], reduce(+) cc[:,:]")
    n, m = sizes.csums
    t1 = time.perf_counter()
    z, ra, ca = csums_inputs((n, m), gen, device)
    since = cluster_sums_cuda.launches
    res = ctx.launch(
        csums, grid=(n, m),
        args={"z": ctx.array(z, dist=RowDist(8), name="z"),
              "row_assign": ctx.array(ra, dist=RowDist(8), name="row_assign"),
              "col_assign": ctx.array(ca, name="col_assign"),
              "cc": ctx.zeros((CS_R, CS_C), name="cc")})
    ctx.synchronize()
    require(ctx.records[-1].comm["cc"].value == "reduce")
    want = cluster_sums_ref(z, ra, ca, CS_R, CS_C)
    err = check_close("launch/cluster_sums", res["cc"].value, want,
                      rtol=1e-4, atol=1e-3)
    mass = float(res["cc"].value.double().sum())
    total = float(z.double().sum())
    require(abs(mass - total) <= 1e-4 * total, mass, total)
    out["cluster_sums"] = {
        "shape": [n, m], "R": CS_R, "C": CS_C,
        "kernel_launches": launched("cluster_sums", since, 1),
        "max_abs_err": err[0], "seconds": time.perf_counter() - t1}
    del z, ra, ca, res, want

    # (e) GEMM, f32 and bf16.
    gemm_def = KernelDef.define(
        "gemm", lambda v, info: {"C": gemm(v["A"], v["B"])},
        "global [i, j] => read A[i,:], read B[:,j], write C[i,j]")
    g = sizes.gemm
    for tag, dtype, route in (("gemm", torch.float32, "pipe"),
                              ("gemm_bf16", torch.bfloat16, "wgmma")):
        t1 = time.perf_counter()
        a, b = gemm_inputs(g, g, g, dtype, gen, device)
        since = gemm_cuda.launches
        routes = dict(gemm_cuda.routes)
        res = ctx.launch(
            gemm_def, grid=(g, g),
            args={"A": ctx.array(a, dist=RowDist(), name="A"),
                  "B": ctx.array(b, dist=RowDist(), name="B"),
                  "C": ctx.zeros((g, g), dtype=dtype, dist=RowDist(),
                                 name="C")})
        ctx.synchronize()
        err = gemm_check(f"launch/{tag}", res["C"].value, gemm_ref(a, b), a,
                         b)
        taken = gemm_cuda.routes[route] - routes[route]
        require(taken == 1 or not on_card, tag, "took route", route, taken,
                "times:", gemm_cuda.routes, "before", routes)
        out[tag] = {"shape": [g, g, g], "dtype": str(dtype),
                    "kernel_launches": launched("gemm", since, 1),
                    "kernel_route": route, "max_abs_err": err[0],
                    **(err[2] if len(err) > 2 else {}),
                    "seconds": time.perf_counter() - t1}
        del a, b, res

    def comm_of_last() -> dict:
        return {k: v.value for k, v in ctx.records[-1].comm.items()}

    # (f) Black-Scholes, every argument block-distributed.
    def bs_body(v, info):
        call, put = black_scholes(v["price"], v["strike"], v["years"])
        return {"call": call, "put": put}

    bs_def = KernelDef.define(
        "black_scholes", bs_body,
        "global i => read price[i], read strike[i], read years[i], "
        "write call[i], write put[i]")
    n = sizes.bs_n
    t1 = time.perf_counter()
    price, strike, years = bs_inputs(n, gen, device)
    dist = BlockDist(n // 8)
    since = black_scholes_cuda.launches
    res = ctx.launch(
        bs_def, grid=(n,), work_dist=BlockWork(n // 8),
        args={"price": ctx.array(price, dist=dist, name="price"),
              "strike": ctx.array(strike, dist=dist, name="strike"),
              "years": ctx.array(years, dist=dist, name="years"),
              "call": ctx.zeros((n,), dist=dist, name="call"),
              "put": ctx.zeros((n,), dist=dist, name="put")})
    ctx.synchronize()
    comm = comm_of_last()
    require(comm == dict.fromkeys(
        ("price", "strike", "years", "call", "put"), "local"), comm)
    err = bs_check("launch/black_scholes",
                   (res["call"].value, res["put"].value),
                   black_scholes_ref(price, strike, years),
                   price, strike, years)
    out["black_scholes"] = {
        "n": n, "comm": comm,
        "kernel_launches": launched("black_scholes", since, 1),
        "max_abs_err": err[0], "seconds": time.perf_counter() - t1}
    del price, strike, years, res

    # (g) SpMV: rows distributed, the whole of x replicated (the paper's
    # over-estimate of an unstructured read).
    spmv_def = KernelDef.define(
        "spmv_ell",
        lambda v, info: {"y": spmv_ell(v["data"], v["cols"], v["x"])},
        "global i => read data[i,:], read cols[i,:], read x[:], write y[i]")
    rows, nnz = sizes.spmv
    t1 = time.perf_counter()
    data, cols, x = spmv_inputs(rows, nnz, rows, gen, device)
    since = spmv_ell_cuda.launches
    bin_since = spmv_ell_cuda.routes["bin"]
    res = ctx.launch(
        spmv_def, grid=(rows,), work_dist=BlockWork(rows // 8),
        args={"data": ctx.array(data, dist=RowDist(8), name="data"),
              "cols": ctx.array(cols, dist=RowDist(8), name="cols"),
              "x": ctx.array(x, name="x"),
              "y": ctx.zeros((rows,), dist=RowDist(8), name="y")})
    ctx.synchronize()
    comm = comm_of_last()
    require(comm == {"data": "local", "cols": "local", "x": "replicated",
                     "y": "local"}, comm)
    err = check_close("launch/spmv_ell", res["y"].value,
                      spmv_ell_ref(data, cols, x), rtol=1e-5, atol=1e-6)
    by_bin = spmv_ell_cuda.routes["bin"] - bin_since
    if on_card:
        require(by_bin == 1, "spmv_ell took route bin", by_bin, "times, not 1")
    out["spmv_ell"] = {
        "rows": rows, "max_nnz": nnz, "n": rows, "comm": comm,
        "kernel_launches": launched("spmv_ell", since, 1),
        "by_route_bin": by_bin,
        "max_abs_err": err[0], "seconds": time.perf_counter() - t1}
    del data, cols, x, res

    # (h) MD5: reduce(min) over the matching keys, once with the target
    # planted near the end and once with no key matching.  On one device
    # the body searches the whole grid.
    md5_def = KernelDef.define("md5", md5_prefix_body,
                               "global i => reduce(min) found[:]",
                               scalars=("target",))
    n = sizes.md5_n
    t1 = time.perf_counter()
    since = md5_search_cuda.launches
    unwind_since = md5_search_cuda.routes["unwind"]
    answers = []
    for target, expect in ((md5_digest(n - MD5_PLANT_BELOW_N),
                            n - MD5_PLANT_BELOW_N), (MD5_NO_MATCH, n)):
        res = ctx.launch(
            md5_def, grid=(n,), work_dist=BlockWork(n // 8),
            scalars={"target": target},
            args={"found": ctx.full((1,), n, dtype=torch.int32,
                                    name="found")})
        answers.append(int(res["found"].value[0]))
        require(answers[-1] == expect, "launch/md5", answers[-1], expect)
    comm = comm_of_last()
    require(comm == {"found": "reduce"}, comm)
    by_unwind = md5_search_cuda.routes["unwind"] - unwind_since
    if on_card:
        require(by_unwind == 2, "md5 took route unwind", by_unwind,
                "times, not 2")
    out["md5"] = {"n": n, "answers": answers, "comm": comm,
                  "kernel_launches": launched("md5", since, 2),
                  "by_route_unwind": by_unwind,
                  "seconds": time.perf_counter() - t1}

    # (i) N-Body: all bodies replicated, accelerations by rows.
    nbody_def = KernelDef.define(
        "nbody", lambda v, info: {"acc": nbody_forces(v["posm"])},
        "global i => read posm[:,:], write acc[i,:]")
    n, s = sizes.nbody_n, sizes.nbody_slab
    t1 = time.perf_counter()
    posm, _ = nbody_inputs(n, gen, device)
    since = nbody_cuda.launches
    tile_since = nbody_cuda.routes["tile"]
    res = ctx.launch(
        nbody_def, grid=(n,), work_dist=BlockWork(n // 8),
        args={"posm": ctx.array(posm, name="posm"),
              "acc": ctx.zeros((n, 3), dist=RowDist(8), name="acc")})
    ctx.synchronize()
    comm = comm_of_last()
    require(comm == {"posm": "replicated", "acc": "local"}, comm)
    err = nbody_slab_check("launch/nbody", res["acc"].value[:s],
                           nbody_forces_ref(posm, rows=(0, s)), posm, 0, s)
    by_tile = nbody_cuda.routes["tile"] - tile_since
    if on_card:
        require(by_tile == 1, "nbody took route tile", by_tile, "times")
    out["nbody"] = {
        "n": n, "checked_targets": s, "comm": comm,
        "kernel_launches": launched("nbody", since, 1),
        "by_route_tile": by_tile,
        "max_abs_err": err[0], "seconds": time.perf_counter() - t1}
    del posm, res

    # (j) the correlator: channels distributed, each superblock correlates
    # its own (the paper distributes channels across GPUs).
    corr_def = KernelDef.define(
        "correlate", lambda v, info: {"vis": correlate(v["samples"])},
        "global c => read samples[c,:,:,:], write vis[c,:,:,:]")
    c, t, a = sizes.corr
    t1 = time.perf_counter()
    (samples,) = corr_inputs(c, t, a, gen, device)
    since = correlate_cuda.launches
    tri_since = correlate_cuda.routes["tri"]
    res = ctx.launch(
        corr_def, grid=(c,), work_dist=BlockWork(max(1, c // 8)),
        args={"samples": ctx.array(samples, dist=RowDist(8), name="samples"),
              "vis": ctx.zeros((c, a, a, 2), dist=RowDist(8), name="vis")})
    ctx.synchronize()
    comm = comm_of_last()
    require(comm == {"samples": "local", "vis": "local"}, comm)
    err = corr_check("launch/correlate", res["vis"].value,
                     correlate_ref(samples), samples)
    launches = launched("correlate", since, 1)
    tri = correlate_cuda.routes["tri"] - tri_since
    if on_card:
        require(tri == launches, "launch/correlate: route tri took", tri,
                "of", launches, "launches")
    out["correlate"] = {
        "shape": [c, t, a], "comm": comm,
        "kernel_launches": launches, "route_tri_launches": tri,
        "max_abs_err": err[0], "seconds": time.perf_counter() - t1}
    del samples, res

    out["launch_records"] = len(ctx.records)
    out["launch_count_metric"] = ctx.registry.snapshot()
    # The mesh pass: five of the applications over MESH_WORKERS workers.
    out["mesh"] = mesh_pass(sizes, device, gen, store)
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    return out


STENCIL_DEF = KernelDef.define(
    "stencil", halo_stencil_body,
    "global i => read input[i-1:i+1], write output[i]")
HOTSPOT_DEF = KernelDef.define(
    "hotspot", halo_hotspot_body,
    "global [i, j] => read temp[i-1:i+1, j-1:j+1], read power[i,j], "
    "write out[i,j]")
KMEANS_DEF = KernelDef.define(
    "kmeans", kmeans_body,
    "global i => read points[i,:], read centroids[:,:], "
    "reduce(+) sums[:,:], reduce(+) counts[:]")
MD5_DEF = KernelDef.define("md5", md5_prefix_body,
                           "global i => reduce(min) found[:]",
                           scalars=("target",))


def gemm_body(views, info):
    return {"C": gemm(views["A"], views["B"])}


GEMM_DEF = KernelDef.define(
    "gemm", gemm_body,
    "global [i, j] => read A[i,:], read B[:,j], write C[i,j]")


def md5_targets(n: int) -> tuple:
    """(digest, expected index) of the planted key, then of no key."""
    return ((md5_digest(n - MD5_PLANT_BELOW_N), n - MD5_PLANT_BELOW_N),
            (MD5_NO_MATCH, n))


def place_stencil(ctx, inp, sizes):
    n, w = sizes.stencil_n, ctx.num_devices
    dist = StencilDist(n // w, 1)
    return (ctx.array(inp["x"], dist=dist, name="input"),
            ctx.zeros((n,), dist=dist, name="output"))


def run_stencil(ctx, placed, sizes):
    """Ten launches with buffer swap."""
    n, w = sizes.stencil_n, ctx.num_devices
    a, b = placed
    for _ in range(10):
        res = ctx.launch(STENCIL_DEF, grid=(n,), work_dist=BlockWork(n // w),
                         args={"input": a, "output": b})
        a, b = res["output"], a
    return a


def place_hotspot(ctx, inp, sizes):
    (rows, cols), w = sizes.hotspot, ctx.num_devices
    slab = rows // w
    return (ctx.array(inp["temp"], dist=StencilDist(slab, 1), name="temp"),
            ctx.array(inp["power"], dist=BlockDist(slab), name="power"),
            ctx.zeros((rows, cols), dist=StencilDist(slab, 1), name="out"))


def run_hotspot(ctx, placed, sizes):
    """The launch phase's steps, buffers swapped."""
    (rows, cols), w = sizes.hotspot, ctx.num_devices
    temp, power, nxt = placed
    for _ in range(sizes.hotspot_steps):
        res = ctx.launch(HOTSPOT_DEF, grid=(rows, cols),
                         work_dist=BlockWork(rows // w),
                         args={"temp": temp, "power": power, "out": nxt})
        temp, nxt = res["out"], temp
    return temp


def place_kmeans(ctx, inp, sizes):
    return (ctx.array(inp["points"], dist=RowDist(ctx.num_devices),
                      name="points"),
            ctx.zeros((KM_K, KM_F), dist=ReplicatedDist(), name="sums"),
            ctx.zeros((KM_K,), dist=ReplicatedDist(), name="counts"),
            torch.from_numpy(np.array(inp["centroids"])).to(ctx.device))


def run_kmeans(ctx, placed, sizes):
    """The launch phase's iterations, reduce(+); the counts and sums of
    each."""
    n, w = sizes.kmeans_n, ctx.num_devices
    points, sums, counts, cen = placed
    trace = []
    for _ in range(sizes.kmeans_iters):
        res = ctx.launch(
            KMEANS_DEF, grid=(n,), work_dist=BlockWork(n // w),
            args={"points": points,
                  "centroids": ctx.array(cen, name="centroids"),
                  "sums": sums, "counts": counts})
        cnt, tot = res["counts"].value, res["sums"].value
        trace.append((cnt, tot))
        cen = tot / cnt.clamp(min=1.0)[:, None]
    return trace


def place_gemm(ctx, inp, sizes):
    g = sizes.gemm
    return {"A": ctx.array(inp["a"], dist=RowDist(), name="A"),
            "B": ctx.array(inp["b"], dist=RowDist(), name="B"),
            "C": ctx.zeros((g, g), dist=RowDist(), name="C")}


def run_gemm(ctx, placed, sizes):
    """The f32 GEMM, B gathered."""
    g = sizes.gemm
    return ctx.launch(GEMM_DEF, grid=(g, g), args=placed)["C"]


def place_md5(ctx, inp, sizes):
    return None


def run_md5(ctx, placed, sizes):
    """reduce(min): the planted key, then no match."""
    n, w = sizes.md5_n, ctx.num_devices
    return [int(ctx.launch(
        MD5_DEF, grid=(n,), work_dist=BlockWork(n // w),
        scalars={"target": t},
        args={"found": ctx.full((1,), n, dtype=torch.int32,
                                name="found")})["found"].value[0])
        for t, _ in md5_targets(n)]


@dataclasses.dataclass(frozen=True)
class LaunchApp:
    """One application of the mesh and ranks passes: ``place(ctx, inputs,
    sizes)`` puts its arrays on the context's mesh from host arrays,
    ``run(ctx, placed, sizes)`` launches it; its body calls ``wrapper``
    ``launches(sizes)`` times a worker by ``route`` (on the card)."""

    place: Callable
    run: Callable
    wrapper: str | None = None
    route: str | None = None
    launches: Callable = lambda sizes: 0


LAUNCH_APPS = {
    "stencil": LaunchApp(place_stencil, run_stencil),
    "hotspot": LaunchApp(place_hotspot, run_hotspot, "hotspot", None,
                         lambda sizes: sizes.hotspot_steps),
    "kmeans": LaunchApp(place_kmeans, run_kmeans, "kmeans", "private",
                        lambda sizes: sizes.kmeans_iters),
    "gemm": LaunchApp(place_gemm, run_gemm, "gemm", "pipe",
                      lambda sizes: 1),
    "md5": LaunchApp(place_md5, run_md5, "md5", "unwind",
                     lambda sizes: len(md5_targets(sizes.md5_n))),
}


def launch_inputs(tag: str, sizes: Sizes, gen: torch.Generator,
                  device) -> dict:
    """An application's inputs, made on ``device`` from ``gen`` and handed
    back in host memory (each context places them from there)."""
    if tag == "stencil":
        inp = {"x": torch.rand((sizes.stencil_n,), generator=gen,
                               device=device)}
    elif tag == "hotspot":
        temp, power = hotspot_inputs(sizes.hotspot, gen, device)
        inp = {"temp": temp, "power": power}
    elif tag == "kmeans":
        centers = lattice_centers(gen, device)
        inp = {"points": clustered_points(sizes.kmeans_n, centers, gen),
               "centroids": start_centroids(centers, gen)}
    elif tag == "gemm":
        g = sizes.gemm
        a, b = gemm_inputs(g, g, g, torch.float32, gen, device)
        inp = {"a": a, "b": b}
    else:
        inp = {}
    return {k: v.cpu().numpy() for k, v in inp.items()}


def launch_result(result) -> dict:
    """An application's result in host memory, as the store keeps it."""
    if isinstance(result, list) and result and isinstance(result[0], int):
        return {"found": np.asarray(result, dtype=np.int64)}
    if isinstance(result, list):
        return {"counts": torch.stack([c for c, _ in result]).cpu().numpy(),
                "sums": torch.stack([t for _, t in result]).cpu().numpy()}
    return {"whole": result.to_numpy()}


def held_part(arr, whole: np.ndarray) -> torch.Tensor:
    """The part of the whole array ``whole`` that ``arr`` holds: its shard
    on a rank mesh, the whole otherwise; on ``arr``'s device."""
    part = whole
    if is_rank_mesh(arr.mesh):
        part = shard_of(whole, arr.partition_spec(), arr.mesh,
                        local_worker(arr.mesh))
    return torch.from_numpy(np.array(part)).to(arr.device)


def launch_check(name: str, tag: str, result, want: dict,
                 sizes: Sizes) -> dict:
    """``result`` against the one-worker run's ``want`` (host arrays):
    the stencil, HotSpot and the GEMM bit-equal (a rank's shard against
    its part), K-Means' counts equal and sums within rtol 1e-4 atol 1e-3,
    MD5 the same index and n with no match."""
    if tag == "md5":
        expect = [e for _, e in md5_targets(sizes.md5_n)]
        one = [int(v) for v in want["found"]]
        require(result == one == expect, name, "found", result,
                "one worker", one, "expected", expect)
        return {"answers": result}
    if tag == "kmeans":
        err = 0.0
        for it, (cnt, tot) in enumerate(result):
            c1 = torch.from_numpy(np.array(want["counts"][it])).to(
                cnt.device)
            s1 = torch.from_numpy(np.array(want["sums"][it])).to(tot.device)
            require(torch.equal(c1, cnt), name,
                    "counts differ at iteration", it)
            err = max(err, check_close(f"{name}/sums/{it}", tot, s1,
                                       rtol=1e-4, atol=1e-3)[0])
        return {"counts_equal": True, "sums_max_abs_err": err}
    one = held_part(result, want["whole"])
    many = result.value
    require(torch.equal(one, many), name, "differs from one worker by",
            float((one.double() - many.double()).abs().max())
            if one.shape == many.shape else f"shape {tuple(many.shape)}")
    return {"bit_equal": True}


def store_save(store: str, tag: str, arrays: dict) -> None:
    for key, value in arrays.items():
        np.save(os.path.join(store, f"{tag}.{key}.npy"), value)


def store_load(store: str, tag: str) -> dict:
    """An entry of the store, each array memory-mapped: a rank reads only
    the slice it places."""
    prefix = f"{tag}."
    return {name[len(prefix):-4]: np.load(os.path.join(store, name),
                                          mmap_mode="r")
            for name in sorted(os.listdir(store))
            if name.startswith(prefix) and "." not in name[len(prefix):-4]}


def launch_run(ctx, tag: str, inp: dict, sizes: Sizes, device) -> tuple:
    """(result, seconds, peak bytes): ``tag`` placed on ``ctx`` from host
    inputs, then run and synchronized.  The seconds cover the run; the
    peak (card only, else None) covers placement and run, over what the
    card held before."""
    app = LAUNCH_APPS[tag]
    on_card = device.type == "cuda"
    free(device)
    if on_card:
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    placed = app.place(ctx, inp, sizes)
    if is_rank_mesh(ctx.mesh):
        ranks.barrier()
    sync(device)
    t0 = time.perf_counter()
    result = app.run(ctx, placed, sizes)
    ctx.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) - base if on_card \
        else None
    return result, seconds, peak


def counted(name: str, app: LaunchApp, before: tuple, expect: int,
            on_card: bool) -> int | None:
    """The wrapper's launches since ``before`` ((launches, routes)),
    required to be ``expect`` and all by the app's route, on the card."""
    wr = WRAPPERS.get(app.wrapper)
    if wr is None or not on_card:
        return None
    n = wr.launches - before[0]
    require(n == expect, f"{name}:", n, "launches of", app.wrapper, "not",
            expect)
    if app.route:
        by = wr.routes[app.route] - before[1].get(app.route, 0)
        require(by == n, f"{name}:", by, "of", n, "launches by route",
                app.route)
    return n


def wrapper_state(app: LaunchApp) -> tuple:
    wr = WRAPPERS.get(app.wrapper)
    return (wr.launches, dict(getattr(wr, "routes", {}))) if wr else (0, {})


def mesh_pass(sizes: Sizes, device: torch.device, gen: torch.Generator,
              store: str | None = None) -> dict:
    """The launch phase's applications over ``MESH_WORKERS`` workers on the
    one device (``Context(num_workers=...)``), each held against the same
    application over one worker on the same inputs in this run: the
    stencil and HotSpot (HALO) bit-equal, K-Means (REDUCE +) with equal
    counts and sums within rtol 1e-4 atol 1e-3, the f32 GEMM (B by GATHER)
    bit-equal, MD5 (REDUCE min) the same index and n with no match.  Each
    wrapper's counter must rise ``MESH_WORKERS`` times per launch (each
    worker's body calls it), by the route the one-worker run takes; the
    seconds of both runs (synchronized) are what the split costs on one
    card in halo copies, gathers and launches, and their peak device
    bytes (placement included) what each holds.  The inputs are made on
    the card from ``gen`` and placed from host memory; with ``store`` (a
    directory), each application's inputs and one-worker result are
    written there for the ranks pass (``ranks_launch``)."""
    on_card = device.type == "cuda"
    w = MESH_WORKERS
    out = {"workers": w}
    for tag, app in LAUNCH_APPS.items():
        inp = launch_inputs(tag, sizes, gen, device)
        seconds, peaks, counts = {}, {}, {}
        want = None
        for k in (1, w):
            ctx = Context(device=device, num_workers=k)
            before = wrapper_state(app)
            result, seconds[k], peaks[k] = launch_run(ctx, tag, inp, sizes,
                                                      device)
            n = counted(f"mesh/{tag}", app, before,
                        k * app.launches(sizes), on_card)
            if n is not None:
                counts[k] = n
            if k == 1:
                want = launch_result(result)
                if store is not None:
                    store_save(store, tag, inp)
                    store_save(store, tag + ".want", want)
            else:
                detail = launch_check(f"mesh/{tag}", tag, result, want,
                                      sizes)
            del result
        rec = ctx.records[-1]
        out[tag] = {"comm": {a: p.value for a, p in rec.comm.items()},
                    "in_specs": rec.in_specs, "out_specs": rec.out_specs,
                    "seconds_1_worker": seconds[1],
                    f"seconds_{w}_workers": seconds[w],
                    "peak_bytes_1_worker": peaks[1],
                    f"peak_bytes_{w}_workers": peaks[w],
                    **({"kernel_launches": counts} if counts else {}),
                    **detail}
        del inp, want
    return out


# ---------------------------------------------------------------------------
# The launch path over ranks
# ---------------------------------------------------------------------------

#: a rank's peak device bytes over the one-worker run's, at most: K-Means
#: holds a quarter of the points; HotSpot's body adds copies of the shard
#: (the halo'd slab, the padded power, the output)
RANKS_PEAK_SHARE = {"kmeans": 0.30, "hotspot": 0.50}


def ranks_launch(device, sizes: Sizes, store: str, world: int) -> dict:
    """The mesh pass's applications over a rank mesh ``(world,)``
    ``("data",)`` in this rank: each placed from the store's host inputs
    (the rank's slice only), run (``Context(mesh=<DeviceMesh>)``: HALO by
    ``ppermute``, GATHER by the tiled gather, REDUCE by ``psum`` /
    ``pmin``) and held against the one-worker run's result in the store;
    each wrapper's counter at one a launch, by the one-worker run's route.
    Per application: seconds (from a barrier, synchronized), the
    ``collective:*`` spans' seconds, staged bytes and peak device bytes of
    this rank."""
    mesh = make_mesh((world,), ("data",))
    on_card = device.type == "cuda"
    out = {"rank": torch.distributed.get_rank(), "world": world,
           "backend": torch.distributed.get_backend()}
    for tag, app in LAUNCH_APPS.items():
        tracer = Tracer(clock=time.perf_counter)
        ctx = Context(mesh=mesh, device=device, tracer=tracer)
        before = wrapper_state(app)
        staged = ranks.staged_bytes()
        result, seconds, peak = launch_run(ctx, tag, store_load(store, tag),
                                           sizes, device)
        staged = ranks.staged_bytes() - staged
        launches = counted(f"ranks/{tag}", app, before, app.launches(sizes),
                           on_card)
        detail = launch_check(f"ranks/{tag}", tag, result,
                              store_load(store, tag + ".want"), sizes)
        held = result.value.shape if hasattr(result, "value") else None
        spans = collective_seconds(tracer)
        rec = ctx.records[-1]
        out[tag] = {"comm": {a: p.value for a, p in rec.comm.items()},
                    "in_specs": rec.in_specs, "out_specs": rec.out_specs,
                    "seconds": seconds, "peak_bytes": peak,
                    "staged_bytes": staged,
                    "collective_seconds": sum(v["seconds"]
                                              for v in spans.values()),
                    "collectives": spans, "launches": launches,
                    "held_shape": list(held) if held is not None else None,
                    **detail}
        del result
        free(device)
    return out


def ranks_launch_rank(device, sizes: Sizes, store: str) -> dict:
    """The ranks pass alone in a spawned rank."""
    return ranks_launch(device, sizes, store,
                        torch.distributed.get_world_size())


def ranks_summary(runs: list[dict], mesh: dict, device) -> dict:
    """The ranks pass's numbers beside the mesh pass's, and its gates: a
    rank's peak device bytes at most ``RANKS_PEAK_SHARE`` of the one-worker
    run's, and the records equal to the one-controller mesh's."""
    out = {"ranks": len(runs), "backend": runs[0]["backend"]}
    for tag in LAUNCH_APPS:
        per = [r[tag] for r in runs]
        row = {"seconds": max(p["seconds"] for p in per),
               "seconds_by_rank": [p["seconds"] for p in per],
               "collective_seconds_by_rank":
               [p["collective_seconds"] for p in per],
               "collective_share": max(p["collective_seconds"]
                                       / p["seconds"] for p in per),
               "collectives": per[0]["collectives"],
               "staged_bytes_by_rank": [p["staged_bytes"] for p in per],
               "peak_bytes_by_rank": [p["peak_bytes"] for p in per],
               "held_shape": per[0]["held_shape"],
               "launches_by_rank": [p["launches"] for p in per],
               "comm": per[0]["comm"],
               **{k: per[0][k] for k in ("bit_equal", "counts_equal",
                                         "answers") if k in per[0]}}
        if "sums_max_abs_err" in per[0]:
            row["sums_max_abs_err"] = max(p["sums_max_abs_err"]
                                          for p in per)
        one = mesh[tag]
        for key in ("seconds_1_worker", f"seconds_{MESH_WORKERS}_workers",
                    "peak_bytes_1_worker",
                    f"peak_bytes_{MESH_WORKERS}_workers"):
            row["mesh_" + key] = one[key]
        require(all(p["comm"] == one["comm"]
                    and p["in_specs"] == one["in_specs"]
                    and p["out_specs"] == one["out_specs"] for p in per),
                f"ranks/{tag}: records differ from the one-controller mesh")
        if device.type == "cuda" and one["peak_bytes_1_worker"]:
            share = max(p["peak_bytes"] for p in per) \
                / one["peak_bytes_1_worker"]
            row["peak_share_of_1_worker"] = share
            if tag in RANKS_PEAK_SHARE:
                require(share <= RANKS_PEAK_SHARE[tag], f"ranks/{tag}: a "
                        "rank's peak is", share, "of one worker's, over",
                        RANKS_PEAK_SHARE[tag])
        out[tag] = row
    return out


def ranks_counts(runs: list[dict]) -> dict:
    """Wrapper -> launches summed over the ranks."""
    out: dict = {}
    for tag, app in LAUNCH_APPS.items():
        if app.wrapper:
            out[app.wrapper] = out.get(app.wrapper, 0) + sum(
                r[tag]["launches"] or 0 for r in runs)
    return out


def host_points(n: int, centers: np.ndarray, seed: int) -> np.ndarray:
    """(n, f) clustered points in host memory, made cheaply: one seeded
    block of at most 2**20 rows, tiled, with a small offset per tile so
    that the tiles differ while every point stays within 0.5 + 0.064 of its
    lattice centre."""
    rng = np.random.RandomState(seed)
    block_rows = min(n, 1 << 20)
    which = rng.randint(0, centers.shape[0], block_rows)
    block = (centers[which] + rng.rand(block_rows, centers.shape[1]) - 0.5
             ).astype(np.float32)
    data = np.empty((n, centers.shape[1]), np.float32)
    for t, start in enumerate(range(0, n, block_rows)):
        rows = min(block_rows, n - start)
        np.add(block[:rows], np.float32(0.001 * (t % 64)),
               out=data[start:start + rows])
    return data


def overlap_share(intervals) -> float:
    """Share of the copies' time during which a kernel was running too."""
    copy_total = sum(ce - cs for cs, ce, _, _ in intervals)
    hidden = 0.0
    for cs, ce, _, _ in intervals:
        for _, _, ks, ke in intervals:
            hidden += max(0.0, min(ce, ke) - max(cs, ks))
    return hidden / copy_total if copy_total > 0 else 0.0


def phase_stream(sizes: Sizes, device: torch.device, seed: int) -> dict:
    """``stream_kmeans`` over host-resident points, against the same
    iterations computed chunk by chunk with the plain version."""
    t0 = time.perf_counter()
    on_card = device.type == "cuda"
    n, halved = sizes.stream_n, 0
    free = os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    while n * KM_F * 4 * 3 > free and n > sizes.stream_chunk_rows:
        n //= 2  # too little host memory for the data and its staging
        halved += 1
    gen = torch.Generator(device=device).manual_seed(seed)
    centers = lattice_centers(gen, device)
    cen0 = start_centroids(centers, gen)
    t_gen = time.perf_counter()
    pts = host_points(n, centers.cpu().numpy(), seed)
    t_gen = time.perf_counter() - t_gen
    chunk_bytes = sizes.stream_chunk_rows * KM_F * 4

    since = kmeans_cuda.launches
    private_since = kmeans_cuda.routes["private"]
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
    cen, per_iter, kernel_cens = cen0, [], []
    for _ in range(sizes.stream_iters):
        stats = {}
        t1 = time.perf_counter()
        cen = stream_kmeans(pts, cen, chunk_rows=sizes.stream_chunk_rows,
                            device=device, stats=stats)
        sync(device)
        dt = time.perf_counter() - t1
        it = {"seconds": dt, "GB_per_s": pts.nbytes / dt / 1e9,
              "chunks": stats["chunks"]}
        if on_card:
            iv = stats["intervals_ms"]
            it["copy_ms"] = sum(ce - cs for cs, ce, _, _ in iv)
            it["compute_ms"] = sum(ke - ks for _, _, ks, ke in iv)
            it["copy_hidden_share"] = overlap_share(iv)
        per_iter.append(it)
        kernel_cens.append(cen)
    n_chunks = -(-n // sizes.stream_chunk_rows)
    out = {"phase": "stream", "n": n, "f": KM_F, "k": KM_K,
           "bytes": int(pts.nbytes), "halved": halved,
           "chunk_rows": sizes.stream_chunk_rows, "chunk_bytes": chunk_bytes,
           "iterations": per_iter, "generate_seconds": t_gen}
    if on_card:
        peak = torch.cuda.max_memory_allocated(device) - base
        out["peak_device_bytes"] = peak
        # Two chunk buffers, the accumulator and the kernel's partials.
        require(peak <= 2 * chunk_bytes + (8 << 20),
                f"device working set {peak} exceeds two chunks")
        launched = kmeans_cuda.launches - since
        require(launched == sizes.stream_iters * n_chunks,
                f"{launched} kernel launches for {n_chunks} chunks")
        by_private = kmeans_cuda.routes["private"] - private_since
        require(by_private == launched, "kmeans took route private",
                by_private, "of", launched, "times")
        out["kernel_launches"] = launched
        out["by_route_private"] = by_private

    # The same iterations with the plain version, chunk by chunk.
    cen, worst = cen0, 0.0
    for got in kernel_cens:
        want = stream_kmeans(pts, cen, chunk_rows=sizes.stream_chunk_rows,
                             use_kernel=False, device=device)
        # rtol 2e-4 atol 2e-4, the reference's streaming tolerance: the
        # f32 accumulator sums the chunks' partials in another order.
        worst = max(worst, check_close("stream/kmeans", got, want,
                                       rtol=2e-4, atol=2e-4)[0])
        cen = got
    require(torch.isfinite(kernel_cens[-1]).all())
    require(kernel_cens[-1].shape == (KM_K, KM_F))
    out["max_abs_err"] = worst
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    return out


#: bytes of the host link's copies (pinned, each way) and of the device's
#: own copy (read and written: twice this many bytes move)
SIM_COPY_BYTES = 1 << 30
SIM_D2D_BYTES = 2 << 30
#: a measured rate lies within these shares of its ``HardwareModel()``
#: constant, or the constant is not this card's peak
SIM_RATE_RANGE = (0.5, 1.05)
#: prefetch windows the simulator runs the stream phase's plan with
SIM_WINDOWS = (0, 2)
#: ``benchmarks/paper_fig10_chunksize.py:run_one``'s K-Means record: 16
#: bytes (4 f32 features), ~3000 flops (40 clusters x 4 features x the
#: distance math), 16 bytes of device-memory traffic
SIM_RECORD_BYTES, SIM_FLOPS_PER_RECORD = 16, 3000.0
SIM_KMEANS = ("global i => read points[i], read centroids[:], "
              "reduce(+) sums[i]")


def copy_rates(sizes: Sizes, device: torch.device) -> dict:
    """Bytes a second of pinned host->device and device->host copies of
    ``SIM_COPY_BYTES``, and of a device-to-device copy of ``SIM_D2D_BYTES``
    counting the bytes read and the bytes written (CUDA events, median of
    ``sizes.reps`` after a warm-up; None in a rehearsal)."""
    on_card = device.type == "cuda"
    scale = 1 if on_card else 1 << 10  # a rehearsal copies 1 MiB
    nbytes, d2d_bytes = SIM_COPY_BYTES // scale, SIM_D2D_BYTES // scale
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=on_card)
    host.fill_(1)
    dev = torch.empty(nbytes, dtype=torch.uint8, device=device)
    h2d = time_ms(lambda: dev.copy_(host, non_blocking=True), device,
                  sizes.reps)
    d2h = time_ms(lambda: host.copy_(dev, non_blocking=True), device,
                  sizes.reps)
    del host, dev
    src = torch.ones(d2d_bytes, dtype=torch.uint8, device=device)
    dst = torch.empty_like(src)
    d2d = time_ms(lambda: dst.copy_(src), device, sizes.reps)
    del src, dst

    def rate(moved, ms):
        return None if ms is None else moved / (ms / 1e3)

    return {"h2d": rate(nbytes, h2d), "d2h": rate(nbytes, d2h),
            "d2d": rate(2 * d2d_bytes, d2d), "h2d_ms": h2d, "d2h_ms": d2h,
            "d2d_ms": d2d, "copy_bytes": nbytes, "d2d_bytes": d2d_bytes}


def stream_plan(n: int, chunk_rows: int):
    """The stream phase's K-Means as one planned launch, built as
    ``benchmarks/paper_fig10_chunksize.py:run_one`` builds its plan: one
    worker, ``chunk_rows`` records a block."""
    planner = Planner(Topology(1))
    arrays = {
        "points": ArrayMeta("points", (n,), SIM_RECORD_BYTES,
                            BlockDist(chunk_rows)),
        "centroids": ArrayMeta("centroids", (KM_K,), SIM_RECORD_BYTES,
                               ReplicatedDist()),
        "sums": ArrayMeta("sums", (KM_K,), SIM_RECORD_BYTES,
                          ReplicatedDist()),
    }
    return planner.plan_launch("kmeans", parse(SIM_KMEANS), (n,),
                               BlockWork(chunk_rows), arrays).plan


def simulate_stream(n: int, chunk_rows: int, window: int) -> dict:
    """The simulator's prediction for one streamed K-Means iteration on
    ``HardwareModel()``, traced; the trace's export must validate."""
    tracer = Tracer()
    sim = Simulator(HardwareModel(), 1, flops_per_thread=SIM_FLOPS_PER_RECORD,
                    bytes_per_thread=float(SIM_RECORD_BYTES), tracer=tracer,
                    prefetch_window=window)
    res = sim.run(stream_plan(n, chunk_rows))
    errors = validate_chrome_trace(json.loads(tracer.to_json()))
    require(not errors, "the simulation's trace is not a valid Chrome "
            "trace:", errors[:3])
    device0 = analyze(tracer).devices[0]
    transfer = device0.busy["transfer"]
    return {"prefetch_window": window, "seconds_per_iteration": res.makespan,
            "h2d_bytes": res.stats["h2d_bytes"],
            "busy_s": dict(res.busy),
            "overlap_fraction": device0.overlap_fraction,
            # the stream phase's measure: copy time under a kernel
            "copy_hidden_share": device0.overlap / transfer if transfer
            else 0.0,
            "exposed_transfer_s": device0.exposed_transfer,
            "tasks": res.task_count, "stats": res.stats}


def phase_sim(sizes: Sizes, device: torch.device, rows: list[dict],
              stream: dict) -> dict:
    """The simulator's hardware model against the card, and its prediction
    against the stream phase.  The card's copy rates, its FP32 rate (the
    f32 GEMM's route "pipe" at the kernels phase's shape and time) and its
    memory are set beside ``HardwareModel()``'s constants; a measured rate
    outside ``SIM_RATE_RANGE`` of its constant fails the run.  Then the
    port's ``Simulator`` runs the stream phase's own workload (its n after
    any halving, its chunk rows) with each of ``SIM_WINDOWS``, beside the
    seconds and the hidden copy share the stream phase measured; that
    agreement is reported, not gated.  Two runs of one simulation must give
    equal stats and makespan."""
    t0 = time.perf_counter()
    on_card = device.type == "cuda"
    hw = HardwareModel()
    copies = copy_rates(sizes, device)
    gemm_row = next(r for r in rows if r["name"] == "gemm")
    m, k, n_cols = gemm_row["shape"]
    fp32 = (2.0 * m * k * n_cols / (gemm_row["ms"] / 1e3)
            if on_card else None)
    measured = {
        "flops": (fp32, hw.flops, "FP32 of the f32 GEMM, route "
                  f"{gemm_row.get('kernel_route')}, {m}x{k}x{n_cols}"),
        "hbm_bw": (copies["d2d"], hw.hbm_bw, "device-to-device copy, bytes "
                   "read and written"),
        "host_link_bw (h2d)": (copies["h2d"], hw.host_link_bw,
                               "pinned host->device copy"),
        "host_link_bw (d2h)": (copies["d2h"], hw.host_link_bw,
                               "pinned device->host copy"),
    }
    rates = []
    for name, (value, constant, how) in measured.items():
        ratio = None if value is None else value / constant
        rates.append({"name": name, "measured": value, "constant": constant,
                      "ratio": ratio, "how": how, "gated": True})
        if on_card:
            require(SIM_RATE_RANGE[0] <= ratio <= SIM_RATE_RANGE[1], name,
                    f"measured {value:.4g} is {ratio:.3f} of the constant "
                    f"{constant:.4g}, outside {SIM_RATE_RANGE}")
    capacity = (torch.cuda.get_device_properties(device).total_memory
                if on_card else None)
    rates.append({"name": "device_capacity", "measured": capacity,
                  "constant": hw.device_capacity,
                  "ratio": None if capacity is None
                  else capacity / hw.device_capacity,
                  "how": "total_memory", "gated": False})
    rates.append({"name": "ici_bw", "measured": None, "constant": hw.ici_bw,
                  "ratio": None, "how": "NVLink 4, data sheet: one card "
                  "cannot measure it", "gated": False})

    n, chunk_rows = stream["n"], stream["chunk_rows"]
    predicted = [simulate_stream(n, chunk_rows, w) for w in SIM_WINDOWS]
    again = simulate_stream(n, chunk_rows, SIM_WINDOWS[-1])
    require(again["stats"] == predicted[-1]["stats"]
            and again["seconds_per_iteration"]
            == predicted[-1]["seconds_per_iteration"],
            "two runs of one simulation differ")
    iters = stream["iterations"]
    measured_stream = {
        "seconds_per_iteration": [it["seconds"] for it in iters],
        "copy_ms": [it.get("copy_ms") for it in iters],
        "compute_ms": [it.get("compute_ms") for it in iters],
        "copy_hidden_share": [it.get("copy_hidden_share") for it in iters],
    }
    best = min(it["seconds"] for it in iters)
    out = {"phase": "sim", "rates": rates, "copies": copies,
           "workload": {"n": n, "chunk_rows": chunk_rows,
                        "record_bytes": SIM_RECORD_BYTES,
                        "flops_per_record": SIM_FLOPS_PER_RECORD,
                        "halved": stream["halved"]},
           "predicted": [{k: v for k, v in p.items() if k != "stats"}
                         for p in predicted],
           "measured_stream": measured_stream,
           "measured_over_predicted": [
               best / p["seconds_per_iteration"] for p in predicted]}
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    return out


#: Tolerance of the serving path's bf16 logits, kernels against plain
#: versions, as a share of the largest logit: bf16 keeps 8 bits, each layer
#: rounds its kernels' outputs (and the plain path also its attention
#: logits and probabilities, or its scans' reads) at other places than the
#: kernels do, and these differences of ~2^-8 of a layer's output add up
#: through the residual stream; 5e-2 of the largest logit is some ten times
#: that estimate.  It checks the path as a whole, not the kernels: those
#: are held, call by call, to the bf16 limit of the kernels phase
#: (``layer_gaps``).
BF16_LOGIT_TOL = 5e-2
#: f32 at full width: the reference's test_prefill_decode_matches_full_forward.
F32_LOGIT_TOL = 2e-3

#: one model of each family the port serves, in the order the runs go
SERVE_ARCHS = ("phi3-mini-3.8b", "rwkv6-3b", "recurrentgemma-2b",
               "granite-moe-3b-a800m", "whisper-medium")
#: depth of the f32 check at full width: two layers, three for the hybrid,
#: whose two would be two recurrent blocks and no attention block, and six
#: for rwkv6-3b, the most at which its two f32 paths still agree (its
#: logits after each block, tools/depth_divergence.py: 3.6e-5 of the
#: largest logit after block 6, 6e-4 after block 8 and 18 % after 32); the
#: encoder-decoder's cut is two layers on each side
F32_LAYERS = {"dense": 2, "rwkv": 6, "hybrid": 3, "moe": 2, "encdec": 2}
#: With random weights rwkv6-3b amplifies rounding through depth, and the
#: reference's own two WKV paths do so too (tests/test_torch_recurrent.py,
#: test_rwkv_amplifies_rounding_through_depth): in bf16 its kernel and
#: plain paths' logits part by 1.6 % of the largest logit after one block,
#: 4.4 % after two and 62 % after 32 (tools/depth_divergence.py).  So its
#: full-depth bf16 logits are reported, each WKV6 call at full depth is
#: held to the bf16 limit, and its bf16 logits, the prefill then decode
#: among them, are gated at this depth
RWKV_LOGIT_LAYERS = 1


def serve_traffic(sizes: Sizes, vocab: int, seed: int, n: int,
                  prompt: tuple) -> list[Request]:
    """``n`` requests from ``seed``: prompt lengths heavy-tailed over
    ``prompt`` (the shortest times 1 + Lomax(1.5): median about 1.6x
    the shortest, some at the longest), the first request at the longest;
    ``max_new_tokens`` uniform over ``serve_new``; greedy, except every
    fourth request at temperature 0.8."""
    rng = np.random.default_rng(seed)
    lo, hi = prompt
    reqs = []
    for rid in range(n):
        plen = hi if rid == 0 else int(min(hi, lo * (1.0 + rng.pareto(1.5))))
        reqs.append(Request(
            rid=rid, prompt=rng.integers(0, vocab, plen).astype(np.int32),
            max_new_tokens=int(rng.integers(sizes.serve_new[0],
                                            sizes.serve_new[1] + 1)),
            temperature=0.8 if rid % 4 == 3 else 0.0))
    return reqs


@contextlib.contextmanager
def recorded(module, name: str, calls: list | None = None):
    """Every call of ``module.name`` inside the block, as (arguments,
    keyword arguments, result), in the list it yields: ``calls`` where
    given (so that several functions record into one list in the order of
    their calls), else a new one."""
    fn = getattr(module, name)
    calls = [] if calls is None else calls

    def spy(*args, **kw):
        result = fn(*args, **kw)
        calls.append((args, kw, result))
        return result

    setattr(module, name, spy)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


@dataclasses.dataclass(frozen=True)
class Spy:
    """A kernel's calls in a model pass, held call by call against its
    plain version: ``module.name`` is what the model calls, ``plain`` is
    called on f32 copies of the same arguments, ``calls`` is how many a pass
    makes.  A second result is an lse (held to ``BF16_LSE_ATOL`` in bf16)
    or a final state (held to the bf16 limit); ``tol`` is the f32 tolerance
    of the output and of the second result."""
    module: object
    name: str
    plain: object
    calls: int
    second: str = "lse"
    tol: tuple = ATTN_TOL[torch.float32]


def serve_spec(cfg, sizes: Sizes) -> dict:
    """What a family's serving run checks and counts: the kernel calls of
    a prefill and of a decode step, the depth at which the bf16 logits are
    gated (None: the full depth), the check prompt's length, the kernels a
    decode step and a prefill are profiled for, the launches an engine run
    of ``prefills`` and ``steps`` makes and, for a kernel whose route
    depends on the prompt, its launches by route (``expect_routes``, from
    the prompt lengths and the steps)."""
    if cfg.family == "rwkv":
        wkv = Spy(model_rwkv, "wkv6", wkv6_ref, cfg.n_layers, "state",
                  (SCAN_TOL, SCAN_TOL))

        def wkv_routes(prompt_lens, steps):
            # each prefill by the route its length gives, each decode step
            # (T = 1) by "fma"
            chunked = sum(wkv6_route(torch.empty((1, 1, n, 1), device="meta"),
                                     None) == "chunk" for n in prompt_lens)
            return {"wkv6": {
                "chunk": cfg.n_layers * chunked,
                "fma": cfg.n_layers * (len(prompt_lens) - chunked + steps)}}
        return {"prefill": [wkv], "decode": [wkv],
                "logit_layers": RWKV_LOGIT_LAYERS,
                "check_len": sizes.serve_check_len,
                "profile": {"decode_step": ("wkv6_kernel",),
                            "prefill": ("wkv6_deltas_kernel",
                                        "wkv6_carry_kernel",
                                        "wkv6_outputs_kernel")},
                "expect": lambda prefills, steps: {
                    "wkv6": cfg.n_layers * (prefills + steps)},
                "expect_routes": wkv_routes}
    if cfg.family == "hybrid":
        groups, tail = model_rglru.n_groups(cfg)
        rec = 2 * groups + tail
        lru = Spy(model_rglru, "rg_lru", lambda *a, **kw: rg_lru(
            *a, use_ref=True, **kw), rec, "state", (SCAN_TOL, SCAN_TOL))

        def lru_routes(prompt_lens, steps):
            # each prefill by the route its length gives, each decode step
            # (T = 1) by "fma"
            chunked = sum(rg_lru_route(torch.empty((1, n, 1), device="meta"))
                          == "chunk" for n in prompt_lens)
            return {"rg_lru": {
                "chunk": rec * chunked,
                "fma": rec * (len(prompt_lens) - chunked + steps)}}
        return {"prefill": [lru, Spy(model_attention, "flash_attention",
                                     attention_ref, groups)],
                "decode": [lru, Spy(model_attention, "cuda_decode",
                                    decode_attention_ref, groups)],
                "logit_layers": None,
                "check_len": sizes.serve_check_len_window,
                "profile": {"decode_step": ("rg_lru_kernel",
                                            "decode_mma_kernel",
                                            "decode_mma_combine_kernel"),
                            "prefill": ("flash_wgmma_kernel",
                                        "rg_lru_local_kernel",
                                        "rg_lru_outputs_kernel")},
                "expect": lambda prefills, steps: {
                    "rg_lru": rec * (prefills + steps),
                    "flash_attention": groups * prefills,
                    "decode_attention": groups * steps},
                "expect_routes": lru_routes}
    attention_profile = {"decode_step": ("decode_mma_kernel",
                                         "decode_mma_combine_kernel"),
                         "prefill": ("flash_wgmma_kernel",)}
    if cfg.family == "encdec":
        # flash attention in each encoder layer and twice in each decoder
        # layer a prefill (causal self-attention, cross-attention), decode
        # attention twice in each decoder layer a step
        flash = cfg.n_enc_layers + 2 * cfg.n_layers
        return {"prefill": [Spy(model_attention, "flash_attention",
                                attention_ref, flash)],
                "decode": [Spy(model_attention, "cuda_decode",
                               decode_attention_ref, 2 * cfg.n_layers)],
                "logit_layers": None,
                "check_len": sizes.serve_prompt_whisper[1],
                "prompt": sizes.serve_prompt_whisper,
                "max_len": sizes.serve_max_len_whisper,
                "profile": attention_profile,
                "expect": lambda prefills, steps: {
                    "flash_attention": flash * prefills,
                    "decode_attention": 2 * cfg.n_layers * steps}}
    return {"prefill": [Spy(model_attention, "flash_attention", attention_ref,
                            cfg.n_layers)],
            "decode": [Spy(model_attention, "cuda_decode",
                           decode_attention_ref, cfg.n_layers)],
            "logit_layers": None, "check_len": sizes.serve_check_len,
            "profile": attention_profile,
            # the MoE family routes: the plain path replays the kernel
            # path's expert choices (``routing``).  Routed freely, the two
            # bf16 paths of granite-moe-3b choose other experts for 2.6 %
            # of a 2048-token prompt's tokens in its first layer already,
            # and their logits after that layer part by 33 % of the
            # largest (tools/depth_divergence.py on an H100), so no depth
            # exists at which free routing could be gated.  Its prefill
            # then decode check raises the capacity, as the reference's
            # test_prefill_decode_matches_full_forward does
            "replay": cfg.family == "moe",
            "teacher_forced": (cfg.scaled(capacity_factor=8.0)
                               if cfg.family == "moe" else cfg),
            "expect": lambda prefills, steps: {
                "flash_attention": cfg.n_layers * prefills,
                "decode_attention": cfg.n_layers * steps}}


def layer_gaps(what: str, calls, spy: Spy) -> dict:
    """Each call of ``spy``'s kernel in a model pass held against the plain
    version on f32 copies of its own inputs: bf16 within the bf16 limit of
    the kernels phase, f32 within ``spy.tol``.  Returns the worst over the
    calls."""
    require(len(calls) == spy.calls, what, len(calls), spy.name,
            "calls, expected", spy.calls)
    worst = {"calls": len(calls), "max_abs_err": 0.0}
    for i, (args, kw, got) in enumerate(calls):
        want = spy.plain(*as_f32(args), **kw)
        out, second = got if isinstance(got, tuple) else (got, None)
        want_out, want_second = want if isinstance(want, tuple) \
            else (want, None)
        name = f"serve/{what} {spy.name} call {i}"
        if out.dtype == torch.bfloat16:
            if spy.second == "state":
                gap = bf16_check(name, out, want_out)
                share = max(gap["limit_share"], bf16_check(
                    f"{name}/state", second, want_second)["limit_share"])
            else:
                gap = bf16_check(name, out, want_out, second, want_second)
                share = max(gap["limit_share"],
                            gap.get("lse_limit_share", 0.0))
            err = gap["max_abs_err"]
            worst["limit_share"] = max(worst.get("limit_share", 0.0), share)
        else:
            tol, tol2 = spy.tol
            err = check_close(name, out, want_out, rtol=tol, atol=tol)[0]
            if second is not None:
                check_close(f"{name}/{spy.second}", second, want_second,
                            rtol=tol2, atol=tol2)
        worst["max_abs_err"] = max(worst["max_abs_err"], err)
    return worst


def logits_gap(got: torch.Tensor, want: torch.Tensor) -> dict:
    """Largest difference over the largest logit, in float64, and the share
    of positions whose top token agrees; a slab of positions at a time (a
    hybrid's 2600 positions over 256,000 tokens are 2.7 GB in f32)."""
    vocab = want.shape[-1]
    g2, w2 = got.reshape(-1, vocab), want.reshape(-1, vocab)
    rows = max(1, CHECK_SLAB // 4 // vocab)
    diff = logit = 0.0
    agree = 0
    for lo in range(0, w2.shape[0], rows):
        g, w = g2[lo:lo + rows].double(), w2[lo:lo + rows].double()
        require(torch.isfinite(g).all(), "logits have non-finite values")
        diff = max(diff, float((g - w).abs().max()))
        logit = max(logit, float(w.abs().max()))
        agree += int((g.argmax(-1) == w.argmax(-1)).sum())
    return {"max_abs_diff": diff, "max_abs_logit": logit,
            "rel_to_max": diff / logit, "argmax_agree": agree / w2.shape[0]}


@contextlib.contextmanager
def spying(spies: list[Spy]):
    """``recorded`` for each of ``spies``; yields their lists of calls."""
    with contextlib.ExitStack() as stack:
        yield [stack.enter_context(recorded(spy.module, spy.name))
               for spy in spies]


@contextlib.contextmanager
def routing(replay: list | None = None):
    """The expert indices of each ``moe._route`` call inside the block, in
    the list it yields.  With ``replay`` (expert indices shaped like the
    calls' own, in the order of the calls) each call takes the next of
    those experts instead of its own top k, with gates from its own
    probabilities: a plain pass then routes every token as the kernel pass
    did, so that its logits hold the kernels and not top-k's jumps (a
    rounding difference in the router's logits can swap an expert, and the
    logits then part by far more than any tolerance)."""
    route = model_moe._route
    queue = iter(replay) if replay is not None else None
    seen = []

    def spy(lp, x, cfg):
        probs, gates, idx = route(lp, x, cfg)
        if queue is not None:
            idx = next(queue)
            gates = probs.gather(-1, idx)
            gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
        seen.append(idx)
        return probs, gates, idx

    model_moe._route = spy
    try:
        yield seen
    finally:
        model_moe._route = route
    require(queue is None or next(queue, None) is None,
            "routes left to replay")


def expert_sets_agree(a: list, b: list) -> float:
    """The share of (layer, token) whose top-k sets of experts agree
    between two passes' recorded routes."""
    require(len(a) == len(b) > 0, len(a), "routing calls against", len(b))
    same = [(x.sort(-1).values == y.sort(-1).values).all(-1).reshape(-1)
            for x, y in zip(a, b)]
    return float(torch.cat(same).double().mean())


def serve_frames(cfg, gen, device) -> torch.Tensor | None:
    """The encoder's input of one request (1, enc_frames, d_model), normal,
    in the model's dtype; None for a family without an encoder."""
    if cfg.family != "encdec":
        return None
    return torch.randn((1, cfg.enc_frames, cfg.d_model), generator=gen,
                       device=device).to(cfg.torch_dtype)


def prompt_batch(toks: torch.Tensor, frames: torch.Tensor | None) -> dict:
    return {"tokens": toks} if frames is None else {"tokens": toks,
                                                    "frames": frames}


@torch.no_grad()
def serve_check(params, cfg, sizes: Sizes, device, gen, max_len,
                gate_logits: bool = True) -> dict:
    """With the kernels (attention_impl "cuda") against the plain path
    ("naive": the materialized attention and the scans' plain versions) on
    the same weights and the same state: (a) one prefill of the check
    prompt and one decode step of all slots, their prompts spread over
    [1, the check prompt] and each prefilled and spliced in as the engine
    does; every kernel call against its plain version on f32 copies of its
    own inputs (``layer_gaps``), and the logits; (b) a prefill of all but
    the last three tokens of the check prompt and three decode steps,
    against a prefill's logits of those positions ((a)'s; for the MoE
    family one at ``capacity_factor`` 8, where no token is dropped).
    Logits within ``BF16_LOGIT_TOL`` of the largest logit in bf16 and
    ``F32_LOGIT_TOL`` element-wise in f32; with ``gate_logits`` False (a
    model too deep for its logits to judge the kernels,
    ``RWKV_LOGIT_LAYERS``) the bf16 logits are reported, and every kernel
    call is still held.  For the MoE family the plain pass of (a) and the
    passes of (b) replay the routes of the kernel pass they are held
    against (``routing``); a plain pass that routes freely is reported
    beside it, with the share of (layer, token) whose experts agree."""
    plain = cfg.scaled(attention_impl="naive")
    spec = serve_spec(cfg, sizes)
    replay = spec.get("replay", False)
    f32 = cfg.torch_dtype == torch.float32
    n, slots = spec["check_len"], sizes.serve_slots
    max_len = max(max_len, n + 1)
    toks = torch.randint(0, cfg.vocab, (1, n), generator=gen, device=device,
                         dtype=torch.int32)
    frames = serve_frames(cfg, gen, device)
    out = {"prefill_tokens": n}

    def prefill_logits(c, state, replayed=None):
        with routing(replayed) as routes:
            got = model_api.forward(params, toks, c, mode="prefill",
                                    state=state, frames=frames)[0]
        return got, routes

    state = model_api.init_decode_state(cfg, 1, max_len, device)
    with spying(spec["prefill"]) as calls:
        got, kernel_routes = prefill_logits(cfg, state)
    for spy, seen in zip(spec["prefill"], calls):
        out[f"prefill_{spy.name}"] = layer_gaps("prefill", seen, spy)
    del calls, state
    logits = [got, prefill_logits(
        plain, model_api.init_decode_state(plain, 1, max_len, device),
        kernel_routes if replay else None)[0]]
    out["prefill"] = logits_gap(*logits)
    if replay:
        free, free_routes = prefill_logits(
            plain, model_api.init_decode_state(plain, 1, max_len, device))
        out["prefill_free_routing"] = dict(
            logits_gap(free, logits[0]),
            expert_sets_agree=expert_sets_agree(kernel_routes, free_routes))
        del free

    lengths = np.linspace(1, n, slots).astype(int)
    prompts = [torch.randint(0, cfg.vocab, (int(m),), generator=gen,
                             device=device, dtype=torch.int32)
               for m in lengths]
    state = model_api.init_decode_state(cfg, slots, max_len, device)
    for i, p in enumerate(prompts):
        one = model_api.init_decode_state(cfg, 1, max_len, device)
        state = _splice_state(state, model_api.prefill(
            params, prompt_batch(p[None], frames), cfg, one)[1], i)
    step = torch.randint(0, cfg.vocab, (slots, 1), generator=gen,
                         device=device, dtype=torch.int32)
    # A dense model's call writes its own k/v at ``pos`` before reading the
    # cache, and a hybrid's its own ring slot; the recurrent state is not
    # written: both calls read the same prefix.
    with spying(spec["decode"]) as calls, routing() as step_routes:
        dec = [model_api.decode_step(params, step, cfg, state)[0]]
    for spy, seen in zip(spec["decode"], calls):
        out[f"decode_{spy.name}"] = layer_gaps("decode", seen, spy)
    del calls
    with routing(step_routes if replay else None):
        dec.append(model_api.decode_step(params, step, plain, state)[0])
    out["decode"] = dict(logits_gap(*dec), kv_len=(lengths + 1).tolist())
    if replay:
        with routing() as free_routes:
            free = model_api.decode_step(params, step, plain, state)[0]
        out["decode_free_routing"] = dict(
            logits_gap(free, dec[0]),
            expert_sets_agree=expert_sets_agree(step_routes, free_routes))

    tf = spec.get("teacher_forced", cfg)
    full, full_routes = logits[0][:, n - 3:], kernel_routes
    if tf is not cfg:
        got, full_routes = prefill_logits(
            tf, model_api.init_decode_state(tf, 1, max_len, device))
        full = got[:, n - 3:]
        del got

    def replayed(cols):
        return [r[:, cols] for r in full_routes] if replay else None

    one = model_api.init_decode_state(tf, 1, max_len, device)
    with routing(replayed(slice(0, n - 3))):
        _, one = model_api.prefill(params, prompt_batch(toks[:, :n - 3],
                                                        frames), tf, one)
    stepped = []
    for i in range(n - 3, n):
        with routing(replayed(slice(i, i + 1))):
            lg, one = model_api.decode_step(params, toks[:, i:i + 1], tf,
                                            one)
        stepped.append(lg[:, -1])
    stepped = torch.stack(stepped, dim=1)
    out["prefill_then_decode"] = logits_gap(stepped, full)
    if f32:
        for what, got, want in (("prefill", *logits), ("decode", *dec),
                                ("prefill then decode", stepped, full)):
            check_close(f"serve/f32 {what}", got, want, rtol=F32_LOGIT_TOL,
                        atol=F32_LOGIT_TOL)
    elif gate_logits:
        for what in ("prefill", "decode", "prefill_then_decode"):
            require(out[what]["rel_to_max"] <= BF16_LOGIT_TOL, "serve/bf16",
                    what, out[what])
    out["logits_gated"] = f32 or gate_logits
    out["routes_replayed"] = replay
    out["state"] = state  # for the profile, dropped before printing
    out["step"] = step
    return out


def device_us(evt) -> float:
    t = getattr(evt, "device_time_total", None)
    return t if t is not None else getattr(evt, "cuda_time_total", 0.0)


def kernel_device_ms(prof, *names) -> float | None:
    """Device ms of the kernels whose names hold one of ``names``, from
    ``torch.profiler``; None where the profiler saw none."""
    total = sum(device_us(evt) for evt in prof.key_averages()
                if any(n in evt.key for n in names))
    return total / 1e3 if total > 0 else None


def device_breakdown(prof, calls: int, top: int = 8) -> dict:
    """All device time the profiler saw, per call, and its ``top`` largest
    kernels by name: where a step's device time goes."""
    rows = sorted(((device_us(e), e.count, e.key)
                   for e in prof.key_averages() if device_us(e) > 0),
                  reverse=True)
    return {"device_ms": sum(r[0] for r in rows) / 1e3 / calls,
            "top": [{"kernel": key[:100], "ms": us / 1e3 / calls,
                     "launches": n / calls} for us, n, key in rows[:top]]}


@torch.no_grad()
def serve_profile(params, cfg, sizes: Sizes, device, state, step,
                  toks, frames=None) -> dict:
    """The ported kernels' share of a decode step of all slots and of a
    prefill of the check prompt: CUDA-event times of the step (the
    host's issue time included), the device time of all kernels and of the
    ported ones from ``torch.profiler`` over the same calls, the largest
    kernels, and where a call waits for the device."""
    n = sizes.profile_steps
    calls = {
        "decode_step": lambda: model_api.decode_step(params, step, cfg,
                                                     state),
        "prefill": lambda: model_api.prefill(
            params, prompt_batch(toks, frames), cfg,
            model_api.init_decode_state(cfg, 1, toks.shape[1], device)),
    }
    out = {}
    for what, kernels in serve_spec(cfg, sizes)["profile"].items():
        fn = calls[what]
        out[f"{what}_ms"] = time_ms(fn, device, n)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            sync(device)
        out[f"{what}_kernels"] = device_breakdown(prof, n)
        ported_ms = kernel_device_ms(prof, *kernels)
        if ported_ms is not None:
            ported_ms /= n
            out[f"{what}_ported"] = list(kernels)
            out[f"{what}_ported_ms_by_kernel"] = {
                k: (kernel_device_ms(prof, k) or 0.0) / n for k in kernels}
            out[f"{what}_ported_ms"] = ported_ms
            out[f"{what}_ported_share"] = ported_ms / out[f"{what}_ms"]
            out[f"{what}_ported_device_share"] = \
                ported_ms / out[f"{what}_kernels"]["device_ms"]
        out[f"{what}_syncs"] = sync_points(fn)
    return out


def sync_points(fn) -> dict:
    """Where one call waits for the device, by PyTorch's sync debug mode:
    the number of synchronizing operations (it warns at each), and the
    innermost Python frames of the first (it raises there)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    count = sum("synchroniz" in str(w.message) for w in caught)
    first = None
    if count:
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn()
        except RuntimeError as e:
            first = [f"{os.path.relpath(f.filename)}:{f.lineno} {f.name}"
                     for f in traceback.extract_tb(e.__traceback__)][-8:]
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return {"count": count, "first": first}


def pct(values, q) -> float:
    return float(np.percentile(np.asarray(values, np.float64), q))


def phase_serve(sizes: Sizes, device: torch.device, seed: int,
                arch: str) -> dict:
    """LM serving with ``arch`` at full width and depth in bf16: the bf16
    check at full depth, the f32 check at ``F32_LAYERS`` and, for a family
    whose full-depth logits are not gated, the bf16 check at its
    ``logit_layers`` (``serve_check``), the ported kernels' share of a step,
    then ``ServeEngine`` over the
    seeded traffic with every launch counter set to 0 just before and read
    just after."""
    t0 = time.perf_counter()
    on_card = device.type == "cuda"
    cfg = get_smoke_config(arch) if sizes.serve_smoke else get_config(arch)
    require(cfg.attention_impl == "cuda", cfg.attention_impl)
    spec = serve_spec(cfg, sizes)
    prompt = spec.get("prompt", sizes.serve_prompt)
    max_len = spec.get("max_len", prompt[1] + sizes.serve_new[1] + 8)
    gen = torch.Generator(device=device).manual_seed(seed)
    t1 = time.perf_counter()
    params = model_api.init_params(gen, cfg, device)
    sync(device)
    out = {"phase": "serve", "arch": cfg.name, "family": cfg.family,
           "dtype": cfg.dtype, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "n_heads": cfg.n_heads,
           "n_kv_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim,
           "d_ff": cfg.d_ff, "vocab": cfg.vocab,
           **({"wkv_head_dim": cfg.wkv_head_dim} if cfg.family == "rwkv"
              else {}),
           **({"window": cfg.window, "groups_and_tail":
               model_rglru.n_groups(cfg)} if cfg.family == "hybrid" else {}),
           **({"n_experts": cfg.n_experts, "top_k": cfg.top_k,
               "capacity_factor": cfg.capacity_factor}
              if cfg.family == "moe" else {}),
           **({"n_enc_layers": cfg.n_enc_layers,
               "enc_frames": cfg.enc_frames} if cfg.family == "encdec"
              else {}),
           "params": model_api.param_count(params),
           "param_bytes": sum(p.numel() * p.element_size()
                              for p in params.parameters()),
           "init_seconds": time.perf_counter() - t1}

    t1 = time.perf_counter()
    routes_before = route_counts()
    check = serve_check(params, cfg, sizes, device, gen, max_len,
                        gate_logits=spec["logit_layers"] is None)
    state, step = check.pop("state"), check.pop("step")
    # Every bf16 attention call of the check took the tensor cores.
    for name in ("flash_attention", "decode_attention"):
        check[f"{name}_routes"] = {
            r: n - routes_before[name][r]
            for r, n in WRAPPERS[name].routes.items()}
        require(check[f"{name}_routes"]["fma"] == 0, "bf16", name,
                "took route fma:", check[f"{name}_routes"])
    out["check"] = dict(check, seconds=time.perf_counter() - t1)
    if on_card:
        toks = torch.randint(0, cfg.vocab, (1, spec["check_len"]),
                             generator=gen, device=device, dtype=torch.int32)
        t1 = time.perf_counter()
        out["profile"] = serve_profile(params, cfg, sizes, device, state,
                                       step, toks,
                                       serve_frames(cfg, gen, device))
        out["profile"]["seconds"] = time.perf_counter() - t1
    del state, step

    depth = F32_LAYERS[cfg.family]
    cuts = {"check_f32": cfg.scaled(
        n_layers=depth, dtype="float32",
        **({"n_enc_layers": depth} if cfg.family == "encdec" else {}))}
    if spec["logit_layers"] is not None:
        cuts["check_bf16_cut"] = cfg.scaled(n_layers=spec["logit_layers"])
    for key, cut in cuts.items():
        t1 = time.perf_counter()
        cut_params = model_api.init_params(gen, cut, device)
        checked = serve_check(cut_params, cut, sizes, device, gen, max_len)
        for drop in ("state", "step"):
            checked.pop(drop)
        out[key] = dict(checked, n_layers=cut.n_layers,
                        **({"n_enc_layers": cut.n_enc_layers}
                           if cut.family == "encdec" else {}),
                        seconds=time.perf_counter() - t1)
        del cut_params
        if on_card:
            torch.cuda.empty_cache()

    t1 = time.perf_counter()
    reqs = serve_traffic(sizes, cfg.vocab, seed,
                         sizes.serve_requests if cfg.family == "dense"
                         else sizes.serve_requests_recurrent, prompt)
    tracer = Tracer(clock=time.perf_counter)
    engine = ServeEngine(params, cfg, slots=sizes.serve_slots,
                         max_len=max_len, seed=seed, tracer=tracer,
                         device=device)
    out["engine_setup_seconds"] = time.perf_counter() - t1
    # The serving path: every count set to 0 just before, read just after.
    zero_counts()
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    submitted = {}
    t1 = time.perf_counter()
    for r in reqs:
        submitted[r.rid] = time.perf_counter()
        engine.submit(r)
    done = engine.run(max_steps=100_000)
    sync(device)
    wall = time.perf_counter() - t1
    counts = {name: w.launches for name, w in WRAPPERS.items()}
    routes = route_counts()

    require(len(done) == len(reqs), "completed", len(done), "of", len(reqs))
    bad = [(r.rid, r.status, len(r.output), r.max_new_tokens) for r in done
           if r.status != "ok" or len(r.output) != r.max_new_tokens]
    require(not bad, "requests not ok:", bad)
    prefills = [e for e in tracer.events if e["name"].startswith("prefill:")]
    steps = [e["dur"] * 1e3 for e in tracer.events
             if e["name"] == "decode_step"]
    ttft = [(e["ts"] + e["dur"] - submitted[e["args"]["rid"]]) * 1e3
            for e in prefills]
    n_steps = engine.stats["steps"]
    require(len(prefills) == len(reqs) and len(steps) == n_steps)
    expect = spec["expect"](len(prefills), n_steps)
    if on_card:
        for name, n in counts.items():
            require(n == expect.get(name, 0), name, "launched", n,
                    "times in the engine run, expected", expect.get(name, 0))
        require(routes["flash_attention"]["wgmma"]
                == counts["flash_attention"], "flash attention routes in "
                "the engine run:", routes["flash_attention"])
        require(routes["decode_attention"]["mma"]
                == counts["decode_attention"], "decode attention routes in "
                "the engine run:", routes["decode_attention"])
    prompt_lens = [e["args"]["prompt_len"] for e in prefills]
    expect_routes = spec.get("expect_routes", lambda *a: {})(prompt_lens,
                                                             n_steps)
    if on_card:
        for name, want in expect_routes.items():
            require(routes[name] == want, name, "routes in the engine run",
                    routes[name], "expected", want)
    tokens = engine.stats["prefill_tokens"] + engine.stats["decode_tokens"]
    out.update({
        "slots": sizes.serve_slots, "max_len": max_len,
        "requests": len(reqs), "completed_ok": len(done),
        "prompt_lengths": sorted(len(r.prompt) for r in reqs),
        "prefill_tokens": engine.stats["prefill_tokens"],
        "decode_tokens": engine.stats["decode_tokens"],
        "decode_steps": n_steps, "retries": engine.stats["retries"],
        "ttft_ms": {"p50": pct(ttft, 50), "p90": pct(ttft, 90),
                    "max": max(ttft)},
        "decode_step_ms": {"p50": pct(steps, 50), "p90": pct(steps, 90)},
        "prefill_ms_by_len": [[n, ms] for n, ms in sorted(
            (e["args"]["prompt_len"], e["dur"] * 1e3) for e in prefills)],
        "engine_seconds": wall,
        "tokens_per_s": tokens / wall,
        "decode_tokens_per_s": engine.stats["decode_tokens"] / wall,
        "kernel_launches": counts, "expected_launches": expect,
        "kernel_routes": routes, "expected_routes": expect_routes,
    })
    if on_card:
        out["peak_device_bytes"] = torch.cuda.max_memory_allocated(device)
    del engine, params
    if on_card:
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    return out

# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

TRAIN_ARCH = "gemma-2b"
#: the peak device memory above which the train run halves its batch
TRAIN_PEAK_SHARE = 0.9
#: the constant rate of the full-depth run, on one batch repeated
TRAIN_LR = 1e-3
#: the fall of the loss that run must show over its steps
TRAIN_LOSS_FALL = 1.0
#: the step the checks' optimizer state is set to (past the default
#: schedule's warm-up, so that the rate moves the params) with moments of
#: scale TRAIN_HISTORY, so that a new master leaf is a smooth function of
#: its gradient rather than its sign (as after a first step from zero
#: moments)
TRAIN_CHECK_STEP = 60
TRAIN_HISTORY = 1e-3
#: card against CPU in f32: the loss, the gradient norm, and each new
#: master and moment leaf (atol + rtol |x|): sums in another order
TRAIN_F32_TOL = {"loss": 1e-5, "grad_norm": 1e-4, "rtol": 1e-4,
                 "atol": 1e-6}
#: two microbatches against one in bf16: the loss
TRAIN_MICRO_LOSS_RTOL = 2e-3
#: a bf16 param against its f32 master: half a bf16 unit in the last place
BF16_HALF_ULP = 2.0 ** -8


@torch.no_grad()
def with_history(state: TrainState, gen: torch.Generator, step: int) -> None:
    """Moments from ``gen`` (mu of scale ``TRAIN_HISTORY``, nu its square
    plus 1e-8) and the step, in place."""
    for name, m in state.opt.master.items():
        h = torch.randn(m.shape, generator=gen, device=m.device) \
            * TRAIN_HISTORY
        state.opt.mu[name].copy_(h)
        state.opt.nu[name].copy_(h * h + 1e-8)
    state.opt.step.fill_(step)


def state_to(state: TrainState, device) -> TrainState:
    """A copy of ``state`` on ``device``: a module of the same structure
    with copies of the parameters, and copies of the optimizer's tensors."""
    memo = {id(p): torch.nn.Parameter(p.detach().to(device, copy=True),
                                      requires_grad=p.requires_grad)
            for p in state.params.parameters()}
    move = lambda tree: {k: v.to(device, copy=True)  # noqa: E731
                         for k, v in tree.items()}
    opt = state.opt
    return TrainState(copy.deepcopy(state.params, memo), AdamWState(
        opt.step.to(device, copy=True), move(opt.master), move(opt.mu),
        move(opt.nu)))


def state_tensors(state: TrainState) -> list[torch.Tensor]:
    """Every tensor of a train state, in a fixed order."""
    opt = state.opt
    return list(state.params.parameters()) + [opt.step] + [
        t for tree in (opt.master, opt.mu, opt.nu) for t in tree.values()]


def train_tokens(cfg, batch: int, seq: int, seed: int, device,
                 step: int = 0) -> dict:
    toks = TokenStream(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                  global_batch=batch, seed=seed)
                       ).batch_at(step)["tokens"]
    return {"tokens": torch.from_numpy(toks).to(device)}


def train_guard(cfg, device) -> dict:
    """Gate 4: a flash-attention call on card tensors that require a
    gradient raises before it launches, and the train step refuses the
    kernels' config."""
    out = {}
    if device.type == "cuda":
        q = torch.randn((1, 8, 64, 256), device=device, dtype=torch.bfloat16,
                        requires_grad=True)
        kv = torch.randn((1, 1, 64, 256), device=device, dtype=torch.bfloat16)
        before = flash_attention_cuda.launches
        refused = False
        try:
            flash_attention(q, kv, kv)
        except RuntimeError as e:
            refused = "no backward" in str(e)
        require(refused and flash_attention_cuda.launches == before,
                "flash attention took a tensor that requires a gradient")
        out["flash_refuses_grad"] = True
    cuda_cfg = dataclasses.replace(cfg, attention_impl="cuda")
    refused = False
    try:
        make_train_step(cuda_cfg)
    except ValueError as e:
        refused = "forward-only" in str(e)
    require(refused, "make_train_step took attention_impl='cuda'")
    out["train_step_refuses_cuda"] = True
    return out


def train_card_vs_cpu(cfg, sizes: Sizes, device, seed: int) -> dict:
    """Gate 1: one step of ``make_train_step`` at full width and
    ``train_check_layers`` layers in f32 (TF32 off) on the card and on the
    CPU from the same state (made on the card, copied to the CPU)."""
    t0 = time.perf_counter()
    c = dataclasses.replace(cfg, n_layers=sizes.train_check_layers,
                            dtype="float32")
    gen = torch.Generator(device=device).manual_seed(seed)
    card = init_train_state(gen, c, device)
    with_history(card, gen, TRAIN_CHECK_STEP)
    cpu = state_to(card, "cpu")
    sync(device)
    parts = {"init_and_copy": time.perf_counter() - t0}
    b, s = sizes.train_check_batch
    batch = train_tokens(c, b, s, seed, "cpu")
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        step = make_train_step(c)
        t1 = time.perf_counter()
        card, mc = step(card, {k: v.to(device) for k, v in batch.items()})
        sync(device)
        parts["card_step"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        cpu, mp = step(cpu, batch)
        parts["cpu_step"] = time.perf_counter() - t1
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    out = {"n_layers": c.n_layers, "dtype": c.dtype, "batch": [b, s],
           "step": int(card.step)}
    for key in ("loss", "grad_norm"):
        got, want = float(mc[key]), float(mp[key])
        out[key] = {"card": got, "cpu": want,
                    "rel": abs(got - want) / abs(want)}
        require(out[key]["rel"] <= TRAIN_F32_TOL[key], "train/f32", key,
                out[key])
    # compared on the card: float64 on the CPU takes seconds a leaf
    t1 = time.perf_counter()
    worst = {}
    for tree in ("master", "mu", "nu"):
        mine, theirs = getattr(card.opt, tree), getattr(cpu.opt, tree)
        gaps = [check_close(f"train/f32 {tree}/{name}", mine[name],
                            theirs[name].to(device),
                            rtol=TRAIN_F32_TOL["rtol"],
                            atol=TRAIN_F32_TOL["atol"])
                for name in theirs]
        worst[tree] = {"max_abs": max(g[0] for g in gaps),
                       "max_rel": max(g[1] for g in gaps)}
    parts["compare"] = time.perf_counter() - t1
    out.update(leaves=len(card.opt.master), gaps=worst,
               seconds_by_part=parts, seconds=time.perf_counter() - t0)
    del card, cpu
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def train_microbatches(cfg, sizes: Sizes, device, seed: int) -> dict:
    """Gate 3: two microbatches against one on the same batch, at full
    width and ``train_check_layers`` layers in bf16, ``donate=False``: the
    loss, and each new bf16 param within half a bf16 ulp of its f32
    master."""
    t0 = time.perf_counter()
    c = dataclasses.replace(cfg, n_layers=sizes.train_check_layers)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    state = init_train_state(gen, c, device)
    with_history(state, gen, TRAIN_CHECK_STEP)
    batch = train_tokens(c, sizes.train_batch, sizes.train_seq, seed,
                         device)
    results = {m: make_train_step(c, microbatches=m, donate=False)(state,
                                                                    batch)
               for m in (1, 2)}
    require(int(state.step) == TRAIN_CHECK_STEP, "donate=False moved the "
            "given state")
    (s1, m1), (s2, m2) = results[1], results[2]
    loss = {"one": float(m1["loss"]), "two": float(m2["loss"])}
    loss["rel"] = abs(loss["two"] - loss["one"]) / abs(loss["one"])
    require(loss["rel"] <= TRAIN_MICRO_LOSS_RTOL, "train/microbatches",
            loss)
    for st in (s1, s2):
        for name, p in st.params.named_parameters():
            m = st.opt.master[name]
            require(bool(((p.float() - m).abs()
                          <= BF16_HALF_ULP * m.abs()).all()),
                    "train/microbatches", name, "is not its master rounded")
    gap = max(float((s2.opt.master[k] - s1.opt.master[k]).abs().max())
              for k in s1.opt.master)
    out = {"n_layers": c.n_layers, "dtype": c.dtype,
           "batch": [sizes.train_batch, sizes.train_seq],
           "microbatches": [1, 2], "loss": loss,
           "grad_norm": [float(m1["grad_norm"]), float(m2["grad_norm"])],
           "master_max_abs_gap": gap, "seconds": time.perf_counter() - t0}
    del state, s1, s2, results
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def train_run(cfg, batch_size: int, sizes: Sizes, device,
              seed: int) -> dict:
    """Gate 2, the training path: gemma-2b at full width and depth, the
    gradient at step 1 (finite, and non-zero somewhere in every
    parameter), then ``train_steps`` steps on one batch at the constant
    rate ``TRAIN_LR`` with every launch count set to 0 just before and read
    just after (the path launches no kernel: the kernels are
    forward-only), the time of each step, the peak memory, one step under
    ``torch.profiler``, and the time of the layers' forward pass that
    remat runs again."""
    on_card = device.type == "cuda"
    seq = sizes.train_seq
    gen = torch.Generator(device=device).manual_seed(seed)
    t1 = time.perf_counter()
    state = init_train_state(gen, cfg, device)
    sync(device)
    out = {"batch": [batch_size, seq], "tokens_per_step": batch_size * seq,
           "params": model_api.param_count(state.params),
           "init_seconds": time.perf_counter() - t1}
    batch = train_tokens(cfg, batch_size, seq, seed, device)

    named = dict(state.params.named_parameters())
    grads = torch.autograd.grad(
        model_api.train_loss(state.params, batch, cfg), list(named.values()))
    for (name, _), g in zip(named.items(), grads):
        require(bool(torch.isfinite(g).all()), "train: gradient of", name,
                "not finite")
        require(bool((g != 0).any()), "train: gradient of", name, "is 0")
    out["grads_checked"] = len(grads)
    del grads

    step_fn = make_train_step(cfg, lr_schedule=lambda step: TRAIN_LR)
    zero_counts()
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    losses, norms, step_ms = [], [], []
    for _ in range(sizes.train_steps):
        t1 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        sync(device)
        step_ms.append((time.perf_counter() - t1) * 1e3)
        norms.append(float(metrics["grad_norm"]))
    counts = {name: w.launches for name, w in WRAPPERS.items()}
    require(not any(counts.values()), "the training path launched a "
            "kernel:", counts)
    require(all(np.isfinite(losses)), "train: losses", losses)
    out.update(losses=losses, grad_norms=norms, step_ms=step_ms,
               kernel_launches=counts)
    if on_card:
        out["peak_device_bytes"] = torch.cuda.max_memory_allocated(device)
        out["total_device_bytes"] = \
            torch.cuda.get_device_properties(device).total_memory
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            state, _ = step_fn(state, batch)
            sync(device)
        out["profile"] = device_breakdown(prof, 1, top=12)
        # the AdamW update alone, on one step's gradients (after the run:
        # it moves the state)
        named = dict(state.params.named_parameters())
        grads = dict(zip(named, torch.autograd.grad(
            model_api.train_loss(state.params, batch, cfg),
            list(named.values()))))
        out["optimizer_ms"] = time_ms(lambda: adamw_update(
            grads, state.opt, TRAIN_LR, param_dtype=cfg.torch_dtype,
            out=named), device, 2)
        del grads, named
        with torch.no_grad():
            out["forward_ms"] = time_ms(
                lambda: model_api.train_loss(state.params, batch, cfg),
                device, sizes.reps)
            hidden = torch.randn((batch_size, seq, cfg.d_model),
                                 generator=gen, device=device,
                                 dtype=cfg.torch_dtype)
            out["head_ms"] = time_ms(lambda: causal_lm_loss(
                rms_norm(hidden, state.params.final_norm["scale"])
                @ state.params.embed.T, batch["tokens"]), device, sizes.reps)
        del hidden
    del state, batch
    if on_card:
        torch.cuda.empty_cache()
    return out


def train_driver(sizes: Sizes, device, seed: int) -> dict:
    """Gate 5: ``run_training`` at the smoke config with a checkpoint
    directory and a failure injected (a ``failure`` and a ``resume`` event
    required), then 10 steps against 5, a save, a restore and 5 more, equal
    bit for bit under ``torch.use_deterministic_algorithms`` (the
    embedding's gradient is an index-add, whose default CUDA backward adds
    with atomics in no fixed order), which needs cuBLAS's workspace fixed
    by ``CUBLAS_WORKSPACE_CONFIG`` (":4096:8", 32 MiB, PyTorch's own size on
    Hopper).  PyTorch reads that variable at every cuBLAS call, and with it
    set a call costs the host more (rwkv6-3b's decode step 44-48 ms against
    67-75 on one card in one run), so it is set for this check alone."""
    t0 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        res = run_training(TRAIN_ARCH, smoke=True, steps=16, batch=2,
                           seq=32, ckpt_dir=os.path.join(tmp, "run"),
                           ckpt_every=4, fail_at_step=10, seed=seed,
                           log_every=100, device=device)
        kinds = [e["kind"] for e in res["events"]]
        require("failure" in kinds and "resume" in kinds
                and res["steps"] == 16, "run_training events", res["events"])
        out["run_training"] = {"events": [(e["kind"], e["step"])
                                          for e in res["events"]],
                               "losses": len(res["losses"]),
                               "first_loss": res["first_loss"],
                               "last_loss": res["last_loss"],
                               "attention_impl": res["attention_impl"]}
        cfg = dataclasses.replace(get_smoke_config(TRAIN_ARCH),
                                  attention_impl="xla")
        step_fn = make_train_step(cfg, donate=False)

        def fresh():
            gen = torch.Generator(device=device).manual_seed(seed)
            return init_train_state(gen, cfg, device)

        def train(state, lo, hi):
            for s in range(lo, hi):
                state, _ = step_fn(state, train_tokens(cfg, 4, 32, seed,
                                                       device, s))
            return state

        deterministic = torch.are_deterministic_algorithms_enabled()
        workspace = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        torch.use_deterministic_algorithms(True)
        try:
            a = train(fresh(), 0, 10)
            mgr = CheckpointManager(os.path.join(tmp, "resume"))
            mgr.save(5, train(fresh(), 0, 5), blocking=True)
            b, meta = mgr.restore(fresh())
            b = train(b, meta["step"], 10)
        finally:
            torch.use_deterministic_algorithms(deterministic)
            if workspace is None:
                del os.environ["CUBLAS_WORKSPACE_CONFIG"]
            else:
                os.environ["CUBLAS_WORKSPACE_CONFIG"] = workspace
        leaves, others = state_tensors(a), state_tensors(b)
        require(len(leaves) == len(others) and all(
            torch.equal(x.detach(), y.detach())
            for x, y in zip(leaves, others)), "train: resume not bit-equal")
        out["resume_bit_equal"] = {"leaves": len(leaves), "steps": 10,
                                   "saved_at": meta["step"],
                                   "deterministic_algorithms": True}
    out["seconds"] = time.perf_counter() - t0
    return out


def train_config(sizes: Sizes):
    """The train phase's config: gemma-2b (its smoke config in a
    rehearsal, with the full config's remat path), the plain attention."""
    full = get_smoke_config(TRAIN_ARCH) if sizes.train_smoke \
        else get_config(TRAIN_ARCH)
    cfg = dataclasses.replace(full, attention_impl="xla")
    if sizes.train_smoke:  # walk the full config's remat path
        cfg = dataclasses.replace(cfg, remat=True)
    return cfg


def phase_train(sizes: Sizes, device: torch.device, seed: int) -> dict:
    """The training path with gemma-2b (``attention_impl="xla"``, the path
    the reference trains through): the guard, the card against the CPU in
    f32, microbatches, the full-depth run (its batch halved while its peak
    passes ``TRAIN_PEAK_SHARE`` of the card) and ``run_training`` with a
    resume."""
    t0 = time.perf_counter()
    on_card = device.type == "cuda"
    cfg = train_config(sizes)
    out = {"phase": "train", "arch": cfg.name, "dtype": cfg.dtype,
           "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
           "head_dim": cfg.head_dim, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
           "tie_embeddings": cfg.tie_embeddings, "remat": cfg.remat,
           "remat_policy": cfg.remat_policy,
           "attention_impl": cfg.attention_impl}
    out["guard"] = train_guard(cfg, device)
    out["card_vs_cpu"] = train_card_vs_cpu(cfg, sizes, device, seed)
    out["microbatches"] = train_microbatches(cfg, sizes, device, seed)

    batch_size, halved = sizes.train_batch, []
    while True:
        t1 = time.perf_counter()
        run = train_run(cfg, batch_size, sizes, device, seed)
        run["run_seconds"] = time.perf_counter() - t1
        if not on_card or batch_size == 1 or run["peak_device_bytes"] \
                <= TRAIN_PEAK_SHARE * run["total_device_bytes"]:
            break
        halved.append({"batch": batch_size,
                       "peak_device_bytes": run["peak_device_bytes"]})
        batch_size //= 2
    losses = run["losses"]
    require(losses[-1] <= losses[0] - TRAIN_LOSS_FALL, "train: the loss "
            f"fell by {losses[0] - losses[-1]}, less than "
            f"{TRAIN_LOSS_FALL}, over one batch repeated", losses)
    out.update(run)
    out["batch_halved"] = halved
    out["first_loss"], out["last_loss"] = losses[0], losses[-1]
    out["grad_norm"] = run["grad_norms"][0]
    if on_card:
        step_s = statistics.median(run["step_ms"][2:]) / 1e3
        flops = model_api.model_flops_for(cfg, "train", batch_size,
                                          sizes.train_seq)
        out.update({
            "median_step_ms_3_to_10": step_s * 1e3,
            "tokens_per_s": batch_size * sizes.train_seq / step_s,
            "model_flops_per_step": flops,
            "model_tflops": flops / step_s / 1e12,
            "bf16_peak_share": flops / step_s / H100_SXM_BF16_FLOPS,
            "peak_share_of_total": run["peak_device_bytes"]
            / run["total_device_bytes"],
            # remat runs the layers' forward pass again in the backward:
            # the full forward's time less the head's (final norm, logits,
            # loss), a share of the step
            "recompute_ms_estimate": run["forward_ms"] - run["head_ms"],
            "recompute_share_estimate": (run["forward_ms"] - run["head_ms"])
            / (step_s * 1e3),
            "optimizer_share": run["optimizer_ms"] / (step_s * 1e3)})
    out["driver"] = train_driver(sizes, device, seed)
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    return out


# ---------------------------------------------------------------------------
# Distribution over ranks
# ---------------------------------------------------------------------------

#: collectives against one process: f32 sums in another order
DIST_SUM_TOL = 1e-5
#: the ring collective matmul against x @ w (atol a share of max |x @ w|)
DIST_MATMUL_TOL = 1e-4
#: a rank's partial decode attention against the whole cache's, in bf16
DIST_DECODE_TOL = ATTN_TOL[torch.bfloat16][0]
#: the mesh axes of the collective runs, a (2, 2) mesh
DIST_AXES = ("pod", "data")
#: seconds the ranks of one spawn may take (the training spawn's f32 check,
#: bf16 runs and save move about 40 GB through the host under gloo)
DIST_TIMEOUT_S = 900.0


#: what every spawned rank's environment sets: the CUDA allocator's
#: segments grow in place, so that four ranks sharing the card hold no
#: gigabytes of fragments each (the dist phase's replicated step peaks at
#: 16.2 GB a rank of 79 GiB)
RANK_ENV = {"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}


def dist_device(device: torch.device):
    """What ``ranks.spawn`` is given: None on a card (each rank on
    ``cuda:rank`` modulo the cards, so all on ``cuda:0`` of one card), the
    CPU in a rehearsal."""
    return None if device.type == "cuda" else "cpu"


def rank_seconds(fn, device, reps: int):
    """(result, median host seconds of ``reps`` calls, bytes staged through
    the host by one call): the ranks call together, so a collective's time
    includes the wait for the slowest."""
    times, staged, out = [], None, None
    for _ in range(max(reps, 1)):
        sync(device)
        before = ranks.staged_bytes()
        t0 = time.perf_counter()
        out = fn()
        sync(device)
        times.append(time.perf_counter() - t0)
        staged = ranks.staged_bytes() - before if staged is None else staged
    return out, statistics.median(times), staged


def dist_record(name, fn, want, device, reps, *, rtol, atol,
                payload: int) -> dict:
    got, seconds, staged = rank_seconds(fn, device, reps)
    err = check_close(f"dist/{name}", got, want, rtol=rtol, atol=atol)
    return {"bytes": payload, "seconds": seconds,
            "gb_per_s": payload / seconds / 1e9, "staged_bytes": staged,
            "max_abs_err": err[0]}


def dist_collectives_rank(device, sizes: Sizes, seed: int,
                          store: str | None = None) -> dict:
    """(a) Each collective on this rank's part of inputs every rank makes
    from ``seed``, held against the one-process computation on all of
    them, with its bytes, seconds, GB/s and staged bytes; then (b)
    flash-decode over 4 shards of the cache; then, with ``store`` (the
    mesh pass's), the ranks pass (``ranks_launch``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    make_mesh((2, 2), DIST_AXES)
    n, me = ranks.axis_size(DIST_AXES), ranks.axis_index(DIST_AXES)
    gen = torch.Generator(device=device).manual_seed(seed)
    reps = max(sizes.reps // 2, 1)
    out = {"rank": me, "device": str(device),
           "backend": torch.distributed.get_backend()}
    m = sizes.dist_elems
    xs = torch.randn((n, m), generator=gen, device=device)
    x = xs[me].contiguous()
    payload = x.numel() * x.element_size()
    out["ring_allreduce_two_phase"] = dist_record(
        "ring_allreduce_two_phase", lambda: ring_allreduce(x, DIST_AXES),
        xs.sum(0), device, reps, rtol=DIST_SUM_TOL, atol=DIST_SUM_TOL,
        payload=payload)
    # a leading dim 4 does not divide: the rotate ring
    xr = torch.randn((n, m + 1, 1), generator=gen, device=device)
    mine = xr[me].contiguous()
    out["ring_allreduce_rotate"] = dist_record(
        "ring_allreduce_rotate", lambda: ring_allreduce(mine, DIST_AXES),
        xr.sum(0), device, reps, rtol=DIST_SUM_TOL, atol=DIST_SUM_TOL,
        payload=mine.numel() * mine.element_size())
    del xr, mine
    rows, inner, cols = sizes.dist_matmul
    a = torch.randn((rows, inner), generator=gen, device=device)
    w = torch.randn((inner, cols), generator=gen, device=device)
    k = inner // n
    a_mine = a[:, me * k:(me + 1) * k].contiguous()
    w_mine = w[me * k:(me + 1) * k].contiguous()
    want = a @ w
    out["ring_allgather_matmul"] = dist_record(
        "ring_allgather_matmul",
        lambda: ring_allgather_matmul(a_mine, w_mine, axis_name=DIST_AXES),
        want, device, reps, rtol=DIST_MATMUL_TOL,
        atol=DIST_MATMUL_TOL * float(want.abs().max()),
        payload=rows * cols * 4)
    del a, w, want, a_mine, w_mine
    flat, _, _ = rank_seconds(lambda: ranks.psum(x, DIST_AXES), device, 1)
    out["hierarchical_grad_allreduce"] = dist_record(
        "hierarchical_grad_allreduce",
        lambda: hierarchical_grad_allreduce({"g": x}, ("data",),
                                            ("pod",))["g"],
        flat, device, reps, rtol=DIST_SUM_TOL, atol=DIST_SUM_TOL,
        payload=payload)
    out["psum_flat"] = dist_record(
        "psum_flat", lambda: ranks.psum(x, DIST_AXES), xs.sum(0), device,
        reps, rtol=DIST_SUM_TOL, atol=DIST_SUM_TOL, payload=payload)
    # int8 with the ranks' largest scale: within scale * n of the sum
    scale = float(xs.abs().max()) / 127
    out["compressed_psum"] = dist_record(
        "compressed_psum",
        lambda: compressed_psum({"g": x}, DIST_AXES)[0]["g"], xs.sum(0),
        device, reps, rtol=0.0, atol=scale * n * 1.01 + 1e-5,
        payload=payload)
    out["compressed_psum"]["limit"] = scale * n * 1.01 + 1e-5
    del xs, x, flat
    out["flash_decode"] = dist_decode_rank(device, sizes, seed)
    if store is not None:
        out["launch"] = ranks_launch(device, sizes, store, n)
    return out


def dist_decode_rank(device, sizes: Sizes, seed: int) -> dict:
    """(b) Flash-decode: this rank's shard of phi3-mini's decode cache (a
    quarter of T along ``"model"``) through the decode-attention kernel
    with its lse, the four partials joined by ``combine_decode_partials``;
    the kernel's launches counted around that path alone, then the result
    held against the kernel on the whole cache and the f32 plain
    version."""
    mesh = make_mesh((ranks.axis_size(DIST_AXES),), ("model",))
    n, me = ranks.axis_size("model"), ranks.axis_index("model")
    b, hq, hkv, t, d = sizes.dist_decode
    shard = t // n
    gen = torch.Generator(device=device).manual_seed(seed + 7)
    q, k, v, kv_len = decode_inputs(sizes.dist_decode, torch.bfloat16, gen,
                                    device)
    lo = me * shard
    k_mine = k[:, :, lo:lo + shard].contiguous()
    v_mine = v[:, :, lo:lo + shard].contiguous()
    local = (kv_len - lo).clamp(0, shard).to(torch.int32)
    zero_counts()
    sync(device)
    t0 = time.perf_counter()
    part, lse = decode_attention(q, k_mine, v_mine, kv_len=local,
                                 with_lse=True)
    combined = model_attention.combine_decode_partials(part, lse, "model")
    sync(device)
    seconds = time.perf_counter() - t0
    launches = decode_attention_cuda.launches
    routes = dict(decode_attention_cuda.routes)
    if device.type == "cuda":
        require(launches == 1 and routes["mma"] == 1, "dist/flash_decode: "
                "one launch by route mma a rank, got", launches, routes)
    empty = (local == 0).nonzero().flatten().tolist()
    for row in empty:
        require(bool((lse[row] == -1e30).all())
                and not bool(part[row].any()),
                "dist/flash_decode: row", row, "of rank", me,
                "holds no key but is not zeros with lse -1e30")
    whole, whole_lse = decode_attention(q, k, v, kv_len=kv_len,
                                        with_lse=True)
    want32 = decode_attention_ref(*as_f32((q, k, v)), kv_len=kv_len,
                                  with_lse=True)
    gap = bf16_check("dist/flash_decode", combined, want32[0])
    gap_whole = bf16_check("dist/flash_decode whole cache", whole,
                           want32[0])
    err = check_close("dist/flash_decode against the whole cache",
                      combined, whole, rtol=DIST_DECODE_TOL,
                      atol=DIST_DECODE_TOL)
    one_row = int((kv_len == 1).nonzero()[0])
    out = {"shape": list(sizes.dist_decode), "shard": shard,
           "mesh": list(mesh.mesh.shape), "kv_len": kv_len.tolist(),
           "local_kv_len": local.tolist(), "empty_rows": empty,
           "row_at_kv_len_1": one_row, "launches": launches,
           "routes": routes, "bf16_limit_share": gap["limit_share"],
           "bf16_limit_share_whole_cache": gap_whole["limit_share"],
           "max_abs_err": gap["max_abs_err"],
           "max_abs_err_against_whole_cache": err[0],
           "path_seconds": seconds}
    out["shard_ms"] = time_ms(lambda: decode_attention(
        q, k_mine, v_mine, kv_len=local, with_lse=True), device, sizes.reps)
    _, out["combine_seconds"], out["combine_staged_bytes"] = rank_seconds(
        lambda: model_attention.combine_decode_partials(part, lse, "model"),
        device, 3)
    return out


def dist_nccl_rank(device, sizes: Sizes, seed: int,
                   store: str | None = None) -> dict:
    """The NCCL path at world size 1 (NCCL refuses two ranks on one card):
    each primitive and collective on a card tensor, which a world of one
    returns as it is, and nothing staged; with ``store``, the ranks pass's
    launches on a rank mesh of 1."""
    mesh = make_mesh((1, 1), DIST_AXES)
    require(torch.distributed.get_backend() == "nccl"
            and mesh.device_type == "cuda", "dist/nccl: backend",
            torch.distributed.get_backend(), mesh.device_type)
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((sizes.dist_elems,), generator=gen, device=device)
    before = ranks.staged_bytes()
    results = {
        "psum": ranks.psum(x, DIST_AXES), "pmax": ranks.pmax(x, DIST_AXES),
        "all_gather": ranks.all_gather(x, DIST_AXES)[0],
        "ppermute": ranks.ppermute(x, DIST_AXES, [(0, 0)]),
        "ring_allreduce": ring_allreduce(x, DIST_AXES),
        "hierarchical_grad_allreduce": hierarchical_grad_allreduce(
            {"g": x}, ("data",), ("pod",))["g"],
        "combine_decode_partials": model_attention.combine_decode_partials(
            x.reshape(1, -1, 1), torch.zeros((1, x.numel()), device=device),
            "data").reshape(-1)}
    for name, got in results.items():
        require(torch.equal(got, x), "dist/nccl:", name, "of one rank is "
                "not its input")
    q, _ = compressed_psum({"g": x}, DIST_AXES)
    scale = float(x.abs().max()) / 127
    check_close("dist/nccl compressed_psum", q["g"], x, rtol=0.0,
                atol=scale * 1.01 + 1e-5)
    _, seconds, _ = rank_seconds(lambda: ranks.psum(x, DIST_AXES), device,
                                 sizes.reps)
    staged = ranks.staged_bytes() - before
    require(staged == 0, "dist/nccl staged", staged, "bytes")
    out = {"backend": "nccl", "world": 1, "checked": sorted(results)
           + ["compressed_psum"], "staged_bytes": staged,
           "psum_seconds": seconds}
    if store is not None:
        out["launch"] = ranks_launch(device, sizes, store, 1)
    return out


def digest(x: torch.Tensor) -> tuple[int, int]:
    """Two int64 sums over the raw bits of ``x`` (the plain one and one
    weighted by position), which a change of any bit moves: a check that
    two copies are equal bit for bit without moving either."""
    bits = x.detach().contiguous().reshape(-1)
    bits = bits.view(torch.int16 if bits.element_size() == 2
                     else torch.int32).to(torch.int64)
    plain = int(bits.sum())
    weighted = 0
    for lo in range(0, bits.numel(), CHECK_SLAB):
        part = bits[lo:lo + CHECK_SLAB]
        pos = torch.arange(lo, lo + part.numel(), device=bits.device)
        weighted += int((part * (pos % 65521 + 1)).sum())
    return plain, weighted


def quarter_digests(x: torch.Tensor, dim: int | None, parts: int) -> list:
    """The digests of ``parts`` equal slices of ``x`` along ``dim`` (the
    whole, once, for None)."""
    if dim is None:
        return [digest(x)]
    return [digest(c) for c in x.chunk(parts, dim=dim)]


def zero1_dim(spec: tuple) -> int | None:
    """The array axis a ZeRO-1 spec splits over ``"data"``."""
    return next((d for d, e in enumerate(spec) if e == "data"
                 or (isinstance(e, tuple) and "data" in e)), None)


def state_digests(state: TrainState, specs, parts: int,
                  first: int = 0) -> dict:
    """Digests of a state's leaves: params whole, every optimizer leaf in
    ``parts`` slices along its ZeRO-1 axis (``first`` the index of this
    state's first slice, where it holds only some)."""
    out = {"step": int(state.opt.step)}
    for name, p in state.params.named_parameters():
        out[f"params/{name}"] = {0: digest(p)}
    for tree in ("master", "mu", "nu"):
        for name, x in getattr(state.opt, tree).items():
            dim = zero1_dim(specs.opt.master[name])
            if dim is None:  # whole on every rank
                out[f"{tree}/{name}"] = {0: digest(x)}
                continue
            out[f"{tree}/{name}"] = {
                first + i: v
                for i, v in enumerate(quarter_digests(x, dim, parts))}
    return out


def dist_train_config(sizes: Sizes):
    full = get_smoke_config(TRAIN_ARCH) if sizes.train_smoke \
        else get_config(TRAIN_ARCH)
    return dataclasses.replace(full, attention_impl="xla",
                               n_layers=sizes.dist_train_layers)


def dist_state(cfg, device, seed: int, history: bool) -> TrainState:
    gen = torch.Generator(device=device).manual_seed(seed)
    state = init_train_state(gen, cfg, device)
    if history:
        with_history(state, gen, TRAIN_CHECK_STEP)
    return state


def free(device) -> None:
    """Memory no longer referenced back to the card: objects held only in
    reference cycles collected first, then the allocator's cache."""
    if device.type == "cuda":
        gc.collect()
        torch.cuda.empty_cache()


def dist_f32_rank(cfg, mesh, batch, device, seed: int) -> dict:
    """(c) In f32: one step on rank 0 alone on the global batch, then the
    ZeRO-1 step of every rank from the same state, held against it leaf by
    leaf (each new optimizer leaf gathered whole in turn)."""
    c32 = dataclasses.replace(cfg, dtype="float32")
    me = ranks.axis_index("data")
    out, one = {}, None
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        if me == 0:
            state, m = make_train_step(c32)(dist_state(c32, device, seed,
                                                       True), batch)
            one = {"loss": float(m["loss"]),
                   "grad_norm": float(m["grad_norm"]),
                   **{tree: {k: v.to("cpu") for k, v in
                             getattr(state.opt, tree).items()}
                      for tree in ("master", "mu", "nu")}}
            del state, m
            free(device)
        ranks.barrier()
        rules = rules_for(c32, mesh, "tp", global_batch=batch["tokens"]
                          .shape[0])
        state = local_train_state(dist_state(c32, device, seed, True), c32,
                                  rules, mesh)
        free(device)
        state, m = make_train_step(c32, rules, mesh)(state, batch)
        specs = train_state_specs(c32, rules)
        worst = {}
        for tree in ("master", "mu", "nu"):
            gaps = []
            for name, x in getattr(state.opt, tree).items():
                whole = ranks.spec_gather(x, specs.opt.master[name])
                if me == 0:
                    gaps.append(check_close(
                        f"dist/f32 {tree}/{name}", whole,
                        one[tree][name].to(device),
                        rtol=TRAIN_F32_TOL["rtol"],
                        atol=TRAIN_F32_TOL["atol"]))
                del whole
            if me == 0:
                worst[tree] = {"max_abs": max(g[0] for g in gaps),
                               "max_rel": max(g[1] for g in gaps)}
        if me == 0:
            for key in ("loss", "grad_norm"):
                got = float(m[key])
                rel = abs(got - one[key]) / abs(one[key])
                out[key] = {"ranks": got, "one_rank": one[key], "rel": rel}
                require(rel <= TRAIN_F32_TOL[key], "dist/f32", key, out[key])
            out["gaps"] = worst
        out["local_master_bytes"] = sum(x.numel() * 4 for x in
                                        state.opt.master.values())
        del state, m
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    free(device)
    ranks.barrier()
    return out


def dist_bf16_rank(cfg, mesh, batch, flavor: str, sizes: Sizes, device,
                   seed: int, directory: str | None) -> dict:
    """(c) In bf16 under ``flavor``: ``dist_train_steps`` steps after one
    to warm up, each step's ms, tokens/s, this rank's peak bytes and the
    gradient all-reduce's share of the step (its spans); under "tp" the
    state is then saved (every leaf gathered whole, rank 0 writing) and
    this rank's digests of it kept, for (d)."""
    tokens = batch["tokens"].numel()
    rules = rules_for(cfg, mesh, flavor, global_batch=batch["tokens"]
                      .shape[0])
    state = local_train_state(dist_state(cfg, device, seed, False), cfg,
                              rules, mesh)
    free(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    step = make_train_step(cfg, rules, mesh, lr_schedule=lambda s: TRAIN_LR)
    tracer = Tracer(clock=time.perf_counter)
    prev = set_tracer(tracer)
    losses, step_s, starts = [], [], []
    staged0 = ranks.staged_bytes()
    try:
        for _ in range(1 + sizes.dist_train_steps):
            sync(device)
            starts.append(time.perf_counter())
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            sync(device)
            step_s.append(time.perf_counter() - starts[-1])
    finally:
        set_tracer(prev)
    require(all(np.isfinite(losses)), "dist/train", flavor, losses)
    timed = step_s[1:]
    reduce_s = sum(e["dur"] for e in tracer.events
                   if e["name"] == "collective:hierarchical_grad_allreduce"
                   and e["ts"] >= starts[1])
    median = statistics.median(timed)
    out = {"flavor": flavor, "losses": losses,
           "step_ms": [x * 1e3 for x in step_s],
           "median_step_ms": median * 1e3,
           "tokens_per_s": tokens / median,
           "allreduce_seconds": reduce_s,
           "allreduce_share": reduce_s / sum(timed),
           "staged_bytes_per_step": (ranks.staged_bytes() - staged0)
           / len(step_s),
           "local_opt_bytes": sum(x.numel() * 4 for tree in
                                  (state.opt.master, state.opt.mu,
                                   state.opt.nu) for x in tree.values())}
    if device.type == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated(device)
    if directory is not None:
        specs = train_state_specs(cfg, rules)
        t0 = time.perf_counter()
        CheckpointManager(directory).save(int(state.step), state,
                                          specs=specs)
        out["save_seconds"] = time.perf_counter() - t0
        me, n = ranks.axis_index("data"), ranks.axis_size("data")
        out["digests"] = state_digests(state, specs, 1, first=me)
        out["digests_of"] = {"parts": n, "index": me}
    del state
    free(device)
    ranks.barrier()
    return out


def dist_train_rank(device, sizes: Sizes, seed: int, directory: str) -> dict:
    """(c) gemma-2b's data-parallel step over a (4, 1) ``("data",
    "model")`` mesh at full width and ``dist_train_layers`` layers: the f32
    check, then the bf16 runs under "tp" (ZeRO-1, saved for (d)) and
    "dp" (replicated)."""
    cfg = dist_train_config(sizes)
    mesh = make_mesh((torch.distributed.get_world_size(), 1),
                     ("data", "model"))
    batch = train_tokens(cfg, sizes.train_batch, sizes.train_seq, seed,
                         device)
    out = {"f32": dist_f32_rank(cfg, mesh, batch, device, seed)}
    for flavor in ("tp", "dp"):
        out[flavor] = dist_bf16_rank(cfg, mesh, batch, flavor, sizes,
                                     device, seed,
                                     directory if flavor == "tp" else None)
    return out


def dist_restore_rank(device, sizes: Sizes, seed: int,
                      directory: str) -> dict:
    """(d) This rank's slices of the saved ZeRO-1 state under the specs of
    a ``("data", "model")`` mesh of this world's ranks, and their digests
    in the quarters the four saving ranks held."""
    cfg = dist_train_config(sizes)
    world = torch.distributed.get_world_size()
    mesh = make_mesh((world, 1), ("data", "model"))
    rules = rules_for(cfg, mesh, "tp")
    specs = train_state_specs(cfg, rules)
    template = dist_state(cfg, device, seed, False)
    state, meta = restore_resharded(CheckpointManager(directory), template,
                                    specs, mesh)
    del template
    me = ranks.axis_index("data")
    parts = sizes.dist_ranks // world
    out = {"world": world, "index": me, "step": meta["step"],
           "digests": state_digests(state, specs, parts, first=me * parts),
           "local_master_shapes": {k: list(v.shape) for k, v in
                                   list(state.opt.master.items())[:2]}}
    del state
    free(device)
    return out


def merged_digests(parts: list[dict]) -> dict:
    """The ranks' digests in one table; the steps as a set, and a slice
    that two ranks hold (a replicated leaf) required equal on both."""
    out: dict = {}
    for p in parts:
        for key, v in p.items():
            if key == "step":
                out.setdefault("step", set()).add(v)
                continue
            mine = out.setdefault(key, {})
            for index, d in v.items():
                require(mine.setdefault(index, d) == d, "dist: ranks hold "
                        "different copies of", key, index)
    return out


def phase_dist(sizes: Sizes, device: torch.device, seed: int,
               store: str | None = None, mesh: dict | None = None) -> dict:
    """The distribution layer over ranks on the one card: 4 ranks under
    gloo (NCCL refuses two ranks on one card; gloo stages a card tensor
    through pinned host memory, which each collective's staged bytes
    count) for (a) the collectives and (b) flash-decode over a
    sequence-sharded cache, then, with the mesh pass's ``store`` and
    numbers (``mesh``), the ranks pass: its applications launched over
    the 4 ranks (``ranks_launch``) and on the NCCL rank as a rank mesh of
    1; one rank under NCCL, (c) gemma-2b's data-parallel step and (d) the
    elastic restore of its ZeRO-1 state onto 2 ranks and 1.  Four ranks
    sharing one card measure correctness and each collective's cost; they
    measure no scaling."""
    t0 = time.perf_counter()
    free(device)
    n = sizes.dist_ranks
    where = dist_device(device)
    out = {"phase": "dist", "ranks": n, "backend": "gloo",
           "rank_device": str(device)}
    if device.type == "cuda":
        # what this process keeps on the card beside the ranks
        out["parent_allocated_bytes"] = torch.cuda.memory_allocated(device)
        out["parent_reserved_bytes"] = torch.cuda.memory_reserved(device)
    if device.type == "cuda":
        # the ranks load the library this process built: none builds it
        _build.load()
    t1 = time.perf_counter()
    coll = ranks.spawn(dist_collectives_rank, n, backend="gloo",
                       device=where, args=(sizes, seed, store),
                       timeout=DIST_TIMEOUT_S, env=RANK_ENV)
    out["spawn_and_collectives_seconds"] = time.perf_counter() - t1
    if store is not None:
        out["ranks_pass"] = ranks_summary([c["launch"] for c in coll], mesh,
                                          device)
        out["ranks_pass_launches"] = ranks_counts([c["launch"]
                                                   for c in coll])
    names = [k for k in coll[0] if isinstance(coll[0][k], dict)
             and "gb_per_s" in coll[0][k]]
    out["collectives"] = {name: {
        "bytes": coll[0][name]["bytes"],
        "seconds": [c[name]["seconds"] for c in coll],
        "gb_per_s": [c[name]["gb_per_s"] for c in coll],
        "staged_bytes": coll[0][name]["staged_bytes"],
        "max_abs_err": max(c[name]["max_abs_err"] for c in coll)}
        for name in names}
    out["collectives"]["compressed_psum"]["limit"] = \
        coll[0]["compressed_psum"]["limit"]
    decode = [c["flash_decode"] for c in coll]
    out["flash_decode"] = {
        **{k: decode[0][k] for k in ("shape", "shard", "mesh", "kv_len",
                                     "row_at_kv_len_1", "routes")},
        "empty_rows_by_rank": [d["empty_rows"] for d in decode],
        "launches_by_rank": [d["launches"] for d in decode],
        "bf16_limit_share": max(d["bf16_limit_share"] for d in decode),
        "bf16_limit_share_whole_cache":
        decode[0]["bf16_limit_share_whole_cache"],
        "max_abs_err": max(d["max_abs_err"] for d in decode),
        "max_abs_err_against_whole_cache":
        max(d["max_abs_err_against_whole_cache"] for d in decode),
        "shard_ms_by_rank": [d["shard_ms"] for d in decode],
        "combine_seconds_by_rank": [d["combine_seconds"] for d in decode],
        "combine_staged_bytes": decode[0]["combine_staged_bytes"]}
    require(sum(d["launches"] for d in decode) == n or device.type != "cuda",
            "dist/flash_decode launches", out["flash_decode"])
    require(len(out["flash_decode"]["empty_rows_by_rank"][-1]) >= 1,
            "dist/flash_decode: no rank held an empty row")
    out["decode_attention_launches"] = sum(d["launches"] for d in decode)
    if device.type == "cuda":
        t1 = time.perf_counter()
        out["nccl"] = ranks.spawn(dist_nccl_rank, 1, backend="nccl",
                                  device=where, args=(sizes, seed, store),
                                  timeout=DIST_TIMEOUT_S, env=RANK_ENV)[0]
        out["nccl"]["spawn_seconds"] = time.perf_counter() - t1
        if store is not None:
            one = out["nccl"].pop("launch")
            out["nccl"]["ranks_pass"] = {
                tag: {k: one[tag][k] for k in ("seconds", "peak_bytes",
                                               "launches", "held_shape")}
                for tag in LAUNCH_APPS}
            out["nccl_launches"] = ranks_counts([one])
    else:
        out["nccl"] = {"skipped": "rehearsal on the CPU: no NCCL"}

    with tempfile.TemporaryDirectory() as tmp:
        directory = os.path.join(tmp, "ckpt")
        t1 = time.perf_counter()
        train = ranks.spawn(dist_train_rank, n, backend="gloo",
                            device=where, args=(sizes, seed, directory),
                            timeout=DIST_TIMEOUT_S, env=RANK_ENV)
        out["train_seconds"] = time.perf_counter() - t1
        cfg = dist_train_config(sizes)
        out["train"] = {
            "arch": cfg.name, "n_layers": cfg.n_layers,
            "d_model": cfg.d_model, "vocab": cfg.vocab,
            "batch": [sizes.train_batch, sizes.train_seq],
            "mesh": [n, 1], "f32_check": train[0]["f32"]}
        for flavor in ("tp", "dp"):
            runs = [t[flavor] for t in train]
            out["train"][flavor] = {
                **{k: runs[0][k] for k in ("losses", "step_ms",
                                           "median_step_ms", "tokens_per_s",
                                           "allreduce_share",
                                           "staged_bytes_per_step",
                                           "local_opt_bytes")},
                "allreduce_share_by_rank": [r["allreduce_share"]
                                            for r in runs],
                "peak_bytes_by_rank": [r.get("peak_bytes") for r in runs]}
        tp_losses = out["train"]["tp"]["losses"]
        require(tp_losses[0] == out["train"]["dp"]["losses"][0],
                "dist/train: the first step's loss differs between tp and "
                "dp from one state", tp_losses,
                out["train"]["dp"]["losses"])
        out["train"]["tp"]["save_seconds"] = train[0]["tp"]["save_seconds"]
        saved = merged_digests([t["tp"]["digests"] for t in train])
        step = saved.pop("step")
        # (d) onto 2 ranks, then onto 1 (this process, whole leaves)
        t1 = time.perf_counter()
        halves = ranks.spawn(dist_restore_rank, 2, backend="gloo",
                             device=where, args=(sizes, seed, directory),
                             timeout=DIST_TIMEOUT_S, env=RANK_ENV)
        out["restore_two_seconds"] = time.perf_counter() - t1
        two = merged_digests([h["digests"] for h in halves])
        t1 = time.perf_counter()
        rules = rules_for(cfg, {"data": 1, "model": 1}, "tp")
        specs = train_state_specs(cfg, rules)
        template = dist_state(cfg, device, seed, False)
        whole, meta = restore_resharded(CheckpointManager(directory),
                                        template, specs, None)
        del template
        one = state_digests(whole, train_state_specs(
            cfg, rules_for(cfg, {"data": n, "model": 1}, "tp")), n)
        del whole
        free(device)
        out["restore_one_seconds"] = time.perf_counter() - t1
        steps = (step, two.pop("step"), {one.pop("step")},
                 {meta["step"]})
        require(all(x == steps[0] for x in steps), "dist/restore: steps",
                steps)
        require(saved == two, "dist/restore: onto 2 ranks not bit-equal")
        require(saved == one, "dist/restore: onto 1 not bit-equal")
        out["restore"] = {"leaves": len(saved), "step": meta["step"],
                          "onto": [2, 1], "bit_equal": True,
                          "local_master_shapes_two":
                          halves[0]["local_master_shapes"]}
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    return out


def phase_ranks(sizes: Sizes, device: torch.device, store: str,
                mesh: dict) -> dict:
    """The ranks pass alone (``tools/dist_probe.py --launch``): the mesh
    pass's applications over 4 gloo ranks on the one card and on one NCCL
    rank, in spawns of their own."""
    t0 = time.perf_counter()
    free(device)
    where = dist_device(device)
    if device.type == "cuda":
        _build.load()
    runs = ranks.spawn(ranks_launch_rank, sizes.dist_ranks, backend="gloo",
                       device=where, args=(sizes, store),
                       timeout=DIST_TIMEOUT_S, env=RANK_ENV)
    out = {"phase": "ranks", **ranks_summary(runs, mesh, device),
           "launches": ranks_counts(runs)}
    if device.type == "cuda":
        one = ranks.spawn(ranks_launch_rank, 1, backend="nccl", device=where,
                          args=(sizes, store), timeout=DIST_TIMEOUT_S,
                          env=RANK_ENV)[0]
        out["nccl"] = {tag: {k: one[tag][k] for k in (
            "seconds", "peak_bytes", "launches", "held_shape")}
            for tag in LAUNCH_APPS}
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    return out


# ---------------------------------------------------------------------------
# Tensor parallelism over ranks
# ---------------------------------------------------------------------------

#: served and trained over a "model" axis of 4 ranks
#: the first bf16 step's loss over (1, 4) against one card's from the same
#: state: the row-split products' partial sums added over the ranks in
#: bf16, in another order than one product's (as two microbatches add
#: theirs)
TP_LOSS_RTOL = TRAIN_MICRO_LOSS_RTOL
#: seconds the ranks of one spawn may take
TP_TIMEOUT_S = 900.0


def tp_config(arch: str, smoke: bool, **kw):
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    return dataclasses.replace(cfg, **kw)


def tp_mesh(shape: tuple):
    return make_mesh(shape, ("data", "model"))


def tp_serve_sizes(cfg, sizes: Sizes) -> dict:
    """A served arch's check prompt, cache length, engine prompts and
    engine traffic over the ranks: the ``tp_*`` sizes, whisper-medium's
    inside its 448-token context (its serve phase's), the hybrid's check
    prompt past its window (its serve phase's); the families added last
    serve ``tp_requests_added`` requests of ``tp_new_added`` tokens."""
    added = cfg.family in ("rwkv", "hybrid", "encdec")
    out = {"check_len": sizes.tp_check_len, "max_len": sizes.tp_max_len,
           "prompt": sizes.tp_prompt,
           "requests": sizes.tp_requests_added if added
           else sizes.tp_requests,
           "new": sizes.tp_new_added if added else sizes.tp_new}
    if cfg.family == "encdec":
        out.update(check_len=min(sizes.tp_check_len,
                                 sizes.serve_prompt_whisper[1]),
                   max_len=sizes.serve_max_len_whisper,
                   prompt=sizes.serve_prompt_whisper)
    elif cfg.family == "hybrid":
        out["check_len"] = sizes.serve_check_len_window
    return out


def state_leaves(state) -> dict:
    """The tensors of a (nested) decode state by path."""
    if isinstance(state, dict):
        return {f"{k}/{p}".rstrip("/"): v for k, sub in state.items()
                for p, v in state_leaves(sub).items()}
    if isinstance(state, list):
        return {f"{i}/{p}".rstrip("/"): v for i, sub in enumerate(state)
                for p, v in state_leaves(sub).items()}
    return {"": state}


def kernel_shape(spy: Spy, args) -> list:
    """The shape of one kernel call, as the kernels phase writes it."""
    if spy.name == "flash_attention":
        q, k = args[:2]
        return [q.shape[0], q.shape[1], k.shape[1], q.shape[2], k.shape[2],
                q.shape[3]]
    if spy.name == "cuda_decode":
        q, k = args[:2]
        return [q.shape[0], q.shape[1], k.shape[1], k.shape[2], q.shape[2]]
    if spy.name == "wkv6":
        return [*args[0].shape, args[2].shape[-1]]
    return list(args[1].shape)  # rg_lru: gx (B, T, D)


def tp_kernel_check(params, cfg, rules, sizes: Sizes, device,
                    gen: torch.Generator) -> dict:
    """One prefill of the check prompt and one decode step on this rank's
    slices, every kernel call of both (``serve_spec``: flash and decode
    attention on the rank's heads, WKV6 on its WKV heads, RG-LRU on its
    channels) held against its plain version on f32 copies of its inputs
    within the bf16 limit."""
    spec, tps = serve_spec(cfg, sizes), tp_serve_sizes(cfg, sizes)
    toks = torch.randint(0, cfg.vocab, (1, tps["check_len"]), generator=gen,
                         device=device, dtype=torch.int32)
    frames = serve_frames(cfg, gen, device)
    state = model_api.init_decode_state(cfg, 1, tps["max_len"], device,
                                        rules)
    out = {"state_shapes": {k: list(v.shape)
                            for k, v in state_leaves(state).items()},
           "shapes": {}}
    split = kvcache.seq_run(rules)[0] > 1
    for what in ("prefill", "decode"):
        with spying(spec[what]) as calls:
            if what == "prefill":
                logits, state = model_api.prefill(
                    params, prompt_batch(toks, frames), cfg, state, rules)
            else:
                logits, state = model_api.decode_step(params, tok, cfg,
                                                      state, rules)
        gaps = {}
        for spy, c in zip(spec[what], calls):
            out["shapes"][f"{what}/{spy.name}"] = kernel_shape(spy, c[0][0])
            gaps[spy.name] = layer_gaps(f"tp {what}", c, spy)
            if split and what == "decode" and spy.name == "cuda_decode":
                out["seq"] = seq_split_check(c, state, cfg, rules,
                                             tps["check_len"] + 1)
        out[what] = {"calls": sum(g["calls"] for g in gaps.values()),
                     "max_abs_err": max(g["max_abs_err"]
                                        for g in gaps.values()),
                     "limit_share": max(g.get("limit_share", 0.0)
                                        for g in gaps.values()),
                     "by_kernel": gaps}
        del calls
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    out["logits_digest"] = digest(logits)
    return out


def seq_split_check(calls, state, cfg, rules, kv_len: int) -> dict:
    """A decode step over a cache split by sequence (``calls``: its
    decode-attention calls on this rank, each on the rank's run with its
    lse): a row whose run holds no key is zeros with lse -1e30; and at
    layer 0 the combined output of the ranks' partials
    (``decode_attention_seq_split``, on the cache after the step) within
    the bf16 limit of the f32 plain version on the whole cache (gathered
    over the ranks) and within ``DIST_DECODE_TOL`` of the kernel on it, as
    the ``dist`` phase holds its flash-decode."""
    t = state["k"].shape[3]
    ranks_n, offset = kvcache.seq_run(rules, t)
    empty = 0
    for i, (_, kw, (o, lse)) in enumerate(calls):
        rows = kw["kv_len"] == 0
        require(not bool(o[rows].any()) and bool((lse[rows] == -1e30).all()),
                "tp/seq: layer", i, "a row with no key in the run of rank",
                offset // t, "is not zeros with lse -1e30")
        empty += int(rows.sum())
    require(empty == (len(calls) if offset >= kv_len else 0), "tp/seq:",
            empty, "empty rows in a run at", offset, "of a row of", kv_len)
    q = calls[0][0][0]
    n = torch.full((q.shape[0],), kv_len, dtype=torch.int32, device=q.device)
    k0, v0 = state["k"][0], state["v"][0]
    combined = model_attention.decode_attention_seq_split(
        q, k0, v0, n, offset, "model", mesh=rules.mesh)
    with ranks.use_mesh(rules.mesh):
        k, v = (torch.cat(list(ranks.all_gather(x.contiguous(),
                                                "model").unbind(0)), dim=2)
                for x in (k0, v0))
    want32 = decode_attention_ref(*as_f32((q, k, v)), kv_len=n)
    gap = bf16_check("tp/seq combined at layer 0", combined, want32)
    whole = decode_attention(q, k, v, kv_len=n)
    err = check_close("tp/seq combined at layer 0 against the whole cache",
                      combined, whole, rtol=DIST_DECODE_TOL,
                      atol=DIST_DECODE_TOL)
    return {"ranks": ranks_n, "run": t, "offset": offset, "kv_len": kv_len,
            "empty_rows": empty, "combined_shape": list(combined.shape),
            "bf16_limit_share": gap["limit_share"],
            "max_abs_err": gap["max_abs_err"],
            "max_abs_err_against_whole_cache": err[0]}


def decode_collectives(engine_tracer, spans) -> dict:
    """The ``collective:*`` spans inside the engine's decode steps: each
    kind's calls, bytes and host seconds over them all."""
    steps = [(e["ts"], e["ts"] + e["dur"]) for e in engine_tracer.events
             if e.get("ph") == "X" and e["name"] == "decode_step"]
    out: dict = {}
    for e in spans.events:
        if e.get("ph") != "X" or not e["name"].startswith("collective:"):
            continue
        if not any(lo <= e["ts"] <= hi for lo, hi in steps):
            continue
        kind = out.setdefault(e["name"].split(":", 1)[1],
                              {"seconds": 0.0, "calls": 0, "bytes": 0})
        kind["seconds"] += e["dur"]
        kind["calls"] += 1
        kind["bytes"] += int(e["args"].get("bytes", 0))
    return out


def collective_seconds(tracer) -> dict:
    """The host seconds, calls and bytes (where a span gives them) of each
    kind of ``collective:*`` span."""
    out: dict = {}
    for e in tracer.events:
        if e.get("ph") == "X" and e["name"].startswith("collective:"):
            kind = out.setdefault(e["name"].split(":", 1)[1],
                                  {"seconds": 0.0, "calls": 0, "bytes": 0})
            kind["seconds"] += e["dur"]
            kind["calls"] += 1
            kind["bytes"] += int(e["args"].get("bytes", 0))
    return out


def tp_engine(params, cfg, rules, sizes: Sizes, device, seed: int,
              slots: int | None = None) -> dict:
    """``ServeEngine`` on this rank's slices on ``slots`` slots (None: the
    serve phase's): the requests of ``tp_serve_sizes``, every count set to
    0 just before, read just after; each kernel's launches as
    ``serve_spec`` counts them for the prefills this rank's data group
    runs (the owner of the slot, where the data ranks split the slots) and
    for the decode steps, by the route each takes."""
    spec, tps = serve_spec(cfg, sizes), tp_serve_sizes(cfg, sizes)
    reqs = serve_traffic(dataclasses.replace(
        sizes, serve_new=(tps["new"], tps["new"])), cfg.vocab, seed,
        tps["requests"], tps["prompt"])
    tracer = Tracer(clock=time.perf_counter)
    engine = ServeEngine(params, cfg, slots=slots or sizes.serve_slots,
                         max_len=tps["max_len"], rules=rules, seed=seed,
                         tracer=tracer, device=device)
    ranks.barrier()
    zero_counts()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    staged0 = ranks.staged_bytes()
    spans = Tracer(clock=time.perf_counter)
    prev = set_tracer(spans)
    submitted = {}
    t1 = time.perf_counter()
    try:
        for r in reqs:
            submitted[r.rid] = time.perf_counter()
            engine.submit(r)
        done = engine.run(max_steps=100_000)
        sync(device)
    finally:
        set_tracer(prev)
    wall = time.perf_counter() - t1
    counts = {name: w.launches for name, w in WRAPPERS.items()}
    routes = route_counts()
    require(len(done) == len(reqs) and all(
        r.status == "ok" and len(r.output) == tps["new"] for r in done),
        "tp: requests not ok:", [(r.rid, r.status, len(r.output))
                                 for r in done])
    prefills = [e for e in tracer.events if e["name"].startswith("prefill:")]
    steps = [e["dur"] * 1e3 for e in tracer.events
             if e["name"] == "decode_step"]
    ttft = [(e["ts"] + e["dur"] - submitted[e["args"]["rid"]]) * 1e3
            for e in prefills]
    n_steps = engine.stats["steps"]
    mine = [e for e in prefills if engine.owns(e["args"]["slot"])]
    expect = spec["expect"](len(mine), n_steps)
    if device.type == "cuda":
        for name, n in counts.items():
            require(n == expect.get(name, 0), "tp:", cfg.name, name,
                    "launched", n, "times in the engine run, expected",
                    expect.get(name, 0))
        want_routes = {"flash_attention": {"wgmma": expect.get(
                           "flash_attention", 0)},
                       "decode_attention": {"mma": expect.get(
                           "decode_attention", 0)}}
        if "expect_routes" in spec:
            want_routes.update(spec["expect_routes"](
                [e["args"]["prompt_len"] for e in mine], n_steps))
        for name, want in want_routes.items():
            got = {r: n for r, n in routes[name].items() if n}
            require(got == {r: n for r, n in want.items() if n}, "tp:",
                    cfg.name, name, "routes in the engine run", got,
                    "expected", want)
    tokens = engine.stats["prefill_tokens"] + engine.stats["decode_tokens"]
    out = {"requests": len(reqs), "prefills": len(prefills),
           "prefills_run": len(mine), "decode_steps": n_steps,
           "cache_bytes": sum(x.numel() * x.element_size() for x in
                              state_leaves(engine.state).values()),
           "prompt_lengths": sorted(len(r.prompt) for r in reqs),
           "outputs": {r.rid: list(r.output) for r in done},
           "ttft_ms": {"p50": pct(ttft, 50), "p90": pct(ttft, 90),
                       "max": max(ttft)},
           "decode_step_ms": {"p50": pct(steps, 50), "p90": pct(steps, 90)},
           "engine_seconds": wall, "tokens_per_s": tokens / wall,
           "decode_tokens_per_s": engine.stats["decode_tokens"] / wall,
           "staged_bytes": ranks.staged_bytes() - staged0,
           "kv_bytes": sum(x.numel() * x.element_size() for k, x in
                           state_leaves(engine.state).items() if k != "pos"),
           "collectives": collective_seconds(spans),
           "decode_collectives": decode_collectives(tracer, spans),
           "kernel_launches": counts, "expected_launches": expect,
           "kernel_routes": {k: routes[k] for k in expect if k in routes}}
    if device.type == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated(device)
    return out


def tp_f32_check(cfg, rules_of, sizes: Sizes, device, seed: int) -> dict:
    """(b) ``cfg`` at ``tp_f32_layers`` layers (the hybrid at three, one
    attention block after two recurrent ones; whisper at as many on each
    side) in f32: a prefill and ``tp_f32_steps`` decode steps with the
    whole model (one rank's path), then with this rank's slices of it over
    the mesh, the logits within the serve phase's f32 limit; an MoE
    model's pass over the mesh replays the whole model's expert choices
    (``routing``)."""
    depth = 3 if cfg.family == "hybrid" else sizes.tp_f32_layers
    c32 = cfg.scaled(n_layers=depth, dtype="float32",
                     **({"n_enc_layers": depth} if cfg.family == "encdec"
                        else {}))
    tps = tp_serve_sizes(cfg, sizes)
    rules = rules_of(c32)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    params = model_api.init_params(gen, c32, device)
    toks = torch.randint(0, c32.vocab, (1, tps["check_len"]), generator=gen,
                         device=device, dtype=torch.int32)
    frames = serve_frames(c32, gen, device)
    steps = torch.randint(0, c32.vocab, (sizes.tp_f32_steps, 1, 1),
                          generator=gen, device=device, dtype=torch.int32)

    def run(r, replay=None):
        state = model_api.init_decode_state(c32, 1, tps["max_len"], device,
                                            r)
        with routing(replay) as routes:
            logits, state = model_api.prefill(
                params, prompt_batch(toks, frames), c32, state, r)
            out = [logits]
            for tok in steps:
                logits, state = model_api.decode_step(params, tok, c32, state,
                                                      r)
                out.append(logits)
        return out, routes

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        one, routes = run(None)
        model_api.local_params(params, c32, rules)
        split, _ = run(rules, routes or None)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    errs = [check_close(f"tp/f32 {cfg.name} "
                        f"{'prefill' if i == 0 else f'step {i}'}", a, b,
                        rtol=F32_LOGIT_TOL, atol=F32_LOGIT_TOL)[0]
            for i, (a, b) in enumerate(zip(split, one))]
    return {"n_layers": c32.n_layers, "prompt": tps["check_len"],
            "decode_steps": sizes.tp_f32_steps, "max_abs_err": max(errs),
            "routes_replayed": len(routes),
            "max_abs_logit": max(float(x.abs().max()) for x in one),
            "limit": F32_LOGIT_TOL}


def tp_serve_one(arch: str, mesh, sizes: Sizes, device,
                 seed: int) -> dict:
    """(a) ``arch`` at full width and depth in bf16 on this rank's slices
    over a (1, 4) mesh: the kernel check, then the engine; (b) the f32
    check at two layers (three for the hybrid)."""
    t0 = time.perf_counter()
    cfg = tp_config(arch, sizes.serve_smoke)
    require(cfg.attention_impl == "cuda", cfg.attention_impl)
    rules = rules_for(cfg, mesh, "tp")
    gen = torch.Generator(device=device).manual_seed(seed)
    params = model_api.init_params(gen, cfg, device, rules)
    free(device)
    out = {"rank": ranks.axis_index("model"),
           "init_seconds": time.perf_counter() - t0,
           "local_params": model_api.param_count(params),
           "local_param_bytes": sum(p.numel() * p.element_size()
                                    for p in params.parameters())}
    out["check"] = tp_kernel_check(params, cfg, rules, sizes, device, gen)
    free(device)
    out["engine"] = tp_engine(params, cfg, rules, sizes, device, seed)
    del params
    free(device)
    out["f32"] = tp_f32_check(cfg, lambda c: rules_for(c, mesh, "tp"),
                              sizes, device, seed)
    free(device)
    out["seconds"] = time.perf_counter() - t0
    return out


def tp_seq_one(arch: str, shape: tuple, shard_seq: bool, sizes: Sizes,
               device, seed: int) -> dict:
    """A cell of ``TP_SEQ_CELLS``: ``arch`` at full width and depth in bf16
    on this rank's slices over a ``shape`` mesh, ``shard_seq`` splitting
    its cache by sequence where the spec lets it: the kernel check (with
    ``seq_split_check`` where it splits), the engine on ``tp_seq_slots``
    slots, the f32 check at two layers; the rank's cache bytes beside one
    card's engine's."""
    t0 = time.perf_counter()
    mesh = tp_mesh(shape)
    cfg = tp_config(arch, sizes.serve_smoke)
    require(cfg.attention_impl == "cuda", cfg.attention_impl)
    rules = rules_for(cfg, mesh, "tp", shard_seq=shard_seq)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = model_api.init_params(gen, cfg, device, rules)
    free(device)
    tps = tp_serve_sizes(cfg, sizes)
    one_card = model_api.init_decode_state(cfg, sizes.tp_seq_slots,
                                           tps["max_len"], "meta")
    out = {"rank": ranks.axis_index(("data", "model")),
           "coords": [ranks.axis_index("data"), ranks.axis_index("model")],
           "seq_ranks": kvcache.seq_run(rules)[0],
           "init_seconds": time.perf_counter() - t0,
           "local_params": model_api.param_count(params),
           "local_param_bytes": sum(p.numel() * p.element_size()
                                    for p in params.parameters()),
           "one_card_kv_bytes": sum(
               x.numel() * x.element_size()
               for k, x in state_leaves(one_card).items() if k != "pos")}
    out["check"] = tp_kernel_check(params, cfg, rules, sizes, device, gen)
    free(device)
    engine = tp_engine(params, cfg, rules, sizes, device, seed,
                       slots=sizes.tp_seq_slots)
    out["engine"] = engine
    out["kv_bytes"] = engine["kv_bytes"]
    del params
    free(device)
    out["f32"] = tp_f32_check(
        cfg, lambda c: rules_for(c, mesh, "tp", shard_seq=shard_seq), sizes,
        device, seed)
    free(device)
    out["seconds"] = time.perf_counter() - t0
    return out


def tp_serve_rank(device, sizes: Sizes, seed: int, archs: tuple,
                  seq_cells: tuple = ()) -> dict:
    """(a) and (b) for each of ``archs`` in turn over (1, 4), then each
    cell of ``seq_cells`` over its own mesh."""
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    if archs:
        mesh = tp_mesh((1, torch.distributed.get_world_size()))
        out.update({arch: tp_serve_one(arch, mesh, sizes, device, seed)
                    for arch in archs})
    for cell in seq_cells:
        out[seq_cell_key(*cell)] = tp_seq_one(*cell, sizes, device, seed)
    return out


def in_turn(fn):
    """``fn()`` on each rank of the current mesh in turn, the others
    waiting (whole states are built one rank at a time)."""
    axes = tuple(ranks.current_mesh().mesh_dim_names)
    out = None
    for turn in range(ranks.axis_size(axes)):
        if ranks.axis_index(axes) == turn:
            out = fn()
        ranks.barrier()
    return out


def tp_train_batch(cfg, sizes: Sizes) -> tuple:
    """A trained arch's global batch over the ranks, (batch, seq): the
    ``tp_train_batch``, the recurrent families' ``tp_train_batch_recurrent``
    (their plain scans step through every token)."""
    return sizes.tp_train_batch_recurrent if cfg.family in (
        "rwkv", "hybrid") else sizes.tp_train_batch


def tp_train_inputs(cfg, sizes: Sizes, seed: int, device) -> dict:
    """A trained arch's global batch (``tp_train_batch``) from the token
    stream, whisper-medium's with frames of the encoder's input from
    ``seed``."""
    b, seq = tp_train_batch(cfg, sizes)
    batch = train_tokens(cfg, b, seq, seed, device)
    if cfg.family == "encdec":
        gen = torch.Generator(device=device).manual_seed(seed + 2)
        batch["frames"] = torch.randn(
            (b, cfg.enc_frames, cfg.d_model), generator=gen,
            device=device).to(cfg.torch_dtype)
    return batch


def tp_train_full(cfg, sizes: Sizes, device, seed: int) -> dict:
    """(c) ``cfg`` at full width and depth in bf16 over (1, 4): one card's
    steps (rank 0, the others waiting; ``tp_train_inputs``), then as many
    steps of every rank from the same state, step 1's loss held against
    one card's."""
    t0 = time.perf_counter()
    n = torch.distributed.get_world_size()
    mesh = tp_mesh((1, n))
    batch = tp_train_inputs(cfg, sizes, seed, device)
    n_steps = sizes.tp_train_steps
    me = ranks.axis_index("model")
    out = {"arch": cfg.name, "n_layers": cfg.n_layers,
           "batch": list(batch["tokens"].shape), "steps": n_steps,
           "mesh": [1, n]}
    if me == 0:
        # one card's first step, whose loss the ranks' first is held to
        state = dist_state(cfg, device, seed, False)
        step = make_train_step(cfg, lr_schedule=lambda s: TRAIN_LR)
        state, m = step(state, batch)
        out["one_card_losses"] = [float(m["loss"])]
        del state, m, step
        free(device)
    ranks.barrier()
    rules = rules_for(cfg, mesh, "tp", global_batch=batch["tokens"].shape[0])
    gen = torch.Generator(device=device).manual_seed(seed)
    state = init_train_state(gen, cfg, device, rules)
    free(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    step = make_train_step(cfg, rules, mesh, lr_schedule=lambda s: TRAIN_LR)
    tracer = Tracer(clock=time.perf_counter)
    prev = set_tracer(tracer)
    losses, step_s, staged = [], [], []
    try:
        for _ in range(n_steps):
            sync(device)
            before = ranks.staged_bytes()
            t1 = time.perf_counter()
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            sync(device)
            step_s.append(time.perf_counter() - t1)
            staged.append(ranks.staged_bytes() - before)
    finally:
        set_tracer(prev)
    require(all(np.isfinite(losses)), "tp/train losses", losses)
    collective = collective_seconds(tracer)
    out.update({"losses": losses, "step_ms": [x * 1e3 for x in step_s],
                "median_step_ms": statistics.median(step_s[1:] or step_s)
                * 1e3,
                "tokens_per_s": batch["tokens"].numel()
                / statistics.median(step_s[1:] or step_s),
                "staged_bytes_per_step": staged,
                "collective_seconds": collective,
                "collective_share": sum(v["seconds"] for v in
                                        collective.values()) / sum(step_s),
                "local_params": model_api.param_count(state.params),
                "local_opt_bytes": sum(x.numel() * 4 for tree in (
                    state.opt.master, state.opt.mu, state.opt.nu)
                    for x in tree.values())})
    if device.type == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated(device)
    if me == 0:
        one = out["one_card_losses"][0]
        out["first_loss_rel"] = abs(losses[0] - one) / one
        require(out["first_loss_rel"] <= TP_LOSS_RTOL, "tp/train: step 1's "
                "loss over (1,", n, ")", losses[0], "against one card's",
                one)
    del state, step
    free(device)
    ranks.barrier()
    out["seconds"] = time.perf_counter() - t0
    return out


#: cells a split dimension of a leaf is cut into for its digests (in each
#: block of a ``ranks.BlockedSpec``'s): every mesh the checkpoint goes
#: between splits a dimension in 1, 2 or 4
TP_CELLS = 4


def tp_cell_digests(state: TrainState, specs, canon) -> dict:
    """Digests of this rank's cells of every leaf: each dimension that
    ``canon`` (the specs of the finest mesh) splits is cut into
    ``TP_CELLS`` equal cells of the whole leaf, and a rank digests the
    cells its slice under ``specs`` on the current mesh holds, keyed by
    their global indices; ``specs`` None: the state is whole.  Cells
    compare across meshes without moving a leaf between ranks.  A
    blocked dimension (the hybrid's ``w_in``) is cut into ``TP_CELLS``
    cells in each of its blocks."""
    def cells(x, spec, canon_spec):
        parts = []  # a dimension's cells: (local start, size, global index)
        for dim, entry in enumerate(canon_spec):
            if entry is None:
                parts.append(None)
                continue
            count, index = 1, 0
            axes = () if spec is None or spec[dim] is None else (
                (spec[dim],) if isinstance(spec[dim], str) else spec[dim])
            axes = tuple(a for a in axes if ranks.axis_size(a) > 1)
            if axes:
                count, index = ranks.axis_size(axes), ranks.axis_index(axes)
            blocks = canon_spec.blocks if isinstance(
                canon_spec, ranks.BlockedSpec) and canon_spec.dim == dim \
                else 1
            size = x.shape[dim] * count // (blocks * TP_CELLS)
            local = x.shape[dim] // blocks  # of a block, on this rank
            parts.append([(b * local + i * size, size,
                           b * TP_CELLS + index * local // size + i)
                          for b in range(blocks)
                          for i in range(local // size)])
        dims = [d for d, p in enumerate(parts) if p is not None]
        out = {}
        for combo in itertools.product(*[parts[d] for d in dims]):
            block, key = x, []
            for d, (start, size, i) in zip(dims, combo):
                block = block.narrow(d, start, size)
                key.append(i)
            out[tuple(key)] = digest(block)
        return out

    out = {"step": int(state.opt.step)}
    for name, p in state.params.named_parameters():
        out[f"params/{name}"] = cells(
            p.detach(), specs and specs.params[name], canon.params[name])
    for tree in ("master", "mu", "nu"):
        for name, x in getattr(state.opt, tree).items():
            out[f"{tree}/{name}"] = cells(
                x, specs and specs.opt.master[name], canon.opt.master[name])
    return out


def sliced_state(state: TrainState, cfg, rules, mesh) -> TrainState:
    """Copies of this rank's slices of every leaf of a whole state under
    ``rules`` on ``mesh``; ``state`` is left as it is."""
    specs = train_state_specs(cfg, rules)
    with ranks.use_mesh(mesh):
        cut = lambda x, spec: ranks.spec_slice(x.detach(), spec).clone(  # noqa
            memory_format=torch.contiguous_format)
        memo = {id(p): torch.nn.Parameter(cut(p, specs.params[name]),
                                          requires_grad=p.requires_grad)
                for name, p in state.params.named_parameters()}
        opt = state.opt
        tree = lambda t: {k: cut(v, specs.opt.master[k])  # noqa: E731
                          for k, v in t.items()}
        return TrainState(copy.deepcopy(state.params, memo), AdamWState(
            opt.step.clone(), tree(opt.master), tree(opt.mu), tree(opt.nu)))


def tp_train_checks(cfg, sizes: Sizes, device, seed: int,
                    directory: str) -> dict:
    """(d) At ``dist_train_layers`` layers: the f32 step over (1, 4) leaf
    by leaf against the one-rank step from the same state (each rank, in
    turn, takes the one-rank step and keeps its slices of the state before
    and after it); a bf16 ZeRO-1 step over (2, 2), saved, then restored
    onto (1, 4) and onto one rank, bit for bit by the digests of each
    leaf's cells, no leaf moved between ranks for them."""
    began = time.perf_counter()
    n = torch.distributed.get_world_size()
    cut = dataclasses.replace(cfg, n_layers=sizes.dist_train_layers,
                              **({"n_enc_layers": sizes.dist_train_layers}
                                 if cfg.family == "encdec" else {}))
    batch = tp_train_inputs(cut, sizes, seed, device)
    mesh = tp_mesh((1, n))
    me = ranks.axis_index("model")
    out = {"n_layers": cut.n_layers}
    c32 = dataclasses.replace(cut, dtype="float32")
    # the f32 steps' inputs in f32 (whisper's frames)
    batch32 = {k: x.float() if x.is_floating_point() else x
               for k, x in batch.items()}
    rules = rules_for(c32, mesh, "tp", global_batch=batch["tokens"].shape[0])
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        def one_rank():
            whole = dist_state(c32, device, seed, True)
            start = sliced_state(whole, c32, rules, mesh)
            with routing() as routes:
                whole, m = make_train_step(c32)(whole, batch32)
            want = sliced_state(whole, c32, rules, mesh)
            metrics = {k: float(m[k]) for k in ("loss", "grad_norm")}
            del whole, m
            free(device)
            return start, want, metrics, routes
        state, want, one, routes = in_turn(one_rank)
        # an MoE step over the ranks routes every token as the one-rank
        # step did: a rounding difference in the router can swap an expert
        with routing(routes or None):
            state, m = make_train_step(c32, rules, mesh)(state, batch32)
        out["routes_replayed"] = len(routes)
        worst = {}
        for tree in ("params", "master", "mu", "nu"):
            if tree == "params":
                got = {k: p.detach() for k, p in
                       state.params.named_parameters()}
                ref = {k: p.detach() for k, p in
                       want.params.named_parameters()}
            else:
                got, ref = getattr(state.opt, tree), getattr(want.opt, tree)
            gaps = [check_close(f"tp/f32 {tree}/{name}", x, ref[name],
                                rtol=TRAIN_F32_TOL["rtol"],
                                atol=TRAIN_F32_TOL["atol"])
                    for name, x in got.items()]
            worst[tree] = {"max_abs": max(g[0] for g in gaps),
                           "max_rel": max(g[1] for g in gaps)}
        for key in ("loss", "grad_norm"):
            got = float(m[key])
            rel = abs(got - one[key]) / abs(one[key])
            out[key] = {"ranks": got, "one_rank": one[key], "rel": rel}
            require(rel <= TRAIN_F32_TOL[key], "tp/f32", key, out[key])
        out["f32_gaps"] = worst
        del state, want, m
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    free(device)
    ranks.barrier()
    out["f32_seconds"] = time.perf_counter() - began

    # a ZeRO-1 step over (2, 2), saved
    mesh = tp_mesh((2, n // 2))
    rules = rules_for(cut, mesh, "tp", global_batch=batch["tokens"].shape[0])
    canon = train_state_specs(cut, rules)

    # every rank at once: its slices of the whole model made from the
    # seed, and their AdamW state (ZeRO-1 slices it at the first step), as
    # a whole state made from the seed and sliced would be
    t1 = time.perf_counter()
    state = init_train_state(torch.Generator(device=device).manual_seed(
        seed), cut, device, rules)
    free(device)
    state, m = make_train_step(cut, rules, mesh, lr_schedule=lambda s:
                               TRAIN_LR)(state, batch)
    out["zero1_seconds"] = time.perf_counter() - t1
    out["zero1_2x2"] = {"loss": float(m["loss"]), "local_master_shapes": {
        k: list(v.shape) for k, v in list(state.opt.master.items())[:3]}}
    require(np.isfinite(out["zero1_2x2"]["loss"]), "tp/2x2 loss")
    t0 = time.perf_counter()
    CheckpointManager(directory).save(int(state.step), state, specs=canon)
    out["save_seconds"] = time.perf_counter() - t0
    out["saved_digests"] = tp_cell_digests(state, canon, canon)
    template = state
    del m
    free(device)
    # onto (1, 4)
    mesh = tp_mesh((1, n))
    specs = train_state_specs(cut, rules_for(cut, mesh, "tp"))
    t0 = time.perf_counter()
    restored, meta = restore_resharded(CheckpointManager(directory),
                                       template, specs, mesh)
    out["restore_seconds"] = time.perf_counter() - t0
    out["restored_digests"] = tp_cell_digests(restored, specs, canon)
    out["restored_step"] = meta["step"]
    del restored, template, state
    free(device)
    ranks.barrier()
    # onto one rank
    if me == 0:
        one_specs = train_state_specs(cut, rules_for(
            cut, {"data": 1, "model": 1}, "tp"))
        template = dist_state(cut, device, seed, False)
        t0 = time.perf_counter()
        whole, meta = restore_resharded(CheckpointManager(directory),
                                        template, one_specs, None)
        out["restore_one_seconds"] = time.perf_counter() - t0
        del template
        out["one_digests"] = tp_cell_digests(whole, None, canon)
        out["one_step"] = meta["step"]
        del whole
        free(device)
    ranks.barrier()
    out["seconds"] = time.perf_counter() - began
    return out


def tp_train_rank(device, sizes: Sizes, seed: int, directory: str,
                  archs: tuple) -> dict:
    """(c) and (d) on this rank for each of ``archs`` in turn; rank 0
    prints each arch's seconds as it ends."""
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"rank": torch.distributed.get_rank()}
    for arch in archs:
        cfg = tp_config(arch, sizes.train_smoke, attention_impl="xla")
        out[arch] = {
            "full": tp_train_full(cfg, sizes, device, seed),
            "checks": tp_train_checks(cfg, sizes, device, seed,
                                      os.path.join(directory, arch))}
        if out["rank"] == 0:
            checks = out[arch]["checks"]
            emit({"phase": "tp_train_arch", "arch": arch,
                  "full_seconds": out[arch]["full"]["seconds"],
                  **{k: checks[k] for k in checks if "seconds" in k}})
    return out


def tp_serve_summary(serve: list, arch: str, device,
                     config: str | None = None) -> dict:
    """One served arch's results over the ranks (``arch``: the key of its
    results, ``config`` the arch where that key names a cell), its gates
    checked."""
    by_rank = [s[arch] for s in serve]
    engines = [s["engine"] for s in by_rank]
    require(all(e["outputs"] == engines[0]["outputs"] for e in engines),
            "tp:", arch, "the ranks' sampled tokens differ")
    digests = [s["check"]["logits_digest"] for s in by_rank]
    require(all(d == digests[0] for d in digests),
            "tp:", arch, "the ranks' gathered logits differ")
    if device.type == "cuda":
        for e in engines:
            require(all(e["kernel_launches"][name] > 0
                        for name in e["expected_launches"]),
                    "tp:", arch, "a rank launched no kernel of its path", e)
    first = by_rank[0]
    cfg = tp_config(config or arch, False)
    kernels = list(first["engine"]["expected_launches"])
    return {
        "arch": arch, "n_layers": cfg.n_layers,
        "local_params": first["local_params"],
        "local_param_bytes": first["local_param_bytes"],
        "init_seconds": max(s["init_seconds"] for s in by_rank),
        "seconds": max(s["seconds"] for s in by_rank),
        "kernel_shapes": first["check"]["shapes"],
        "state_shapes": first["check"]["state_shapes"],
        "bf16_limit_share": {w: max(s["check"][w]["limit_share"]
                                    for s in by_rank)
                             for w in ("prefill", "decode")},
        "calls_checked_by_rank": [s["check"]["prefill"]["calls"]
                                  + s["check"]["decode"]["calls"]
                                  for s in by_rank],
        **{k: first["engine"][k] for k in (
            "requests", "prefills", "decode_steps", "prompt_lengths",
            "kv_bytes",
            "ttft_ms", "decode_step_ms", "engine_seconds", "tokens_per_s",
            "decode_tokens_per_s", "staged_bytes", "collectives",
            "cache_bytes", "expected_launches", "kernel_routes")},
        "launches": {name: sum(e["kernel_launches"][name] for e in engines)
                     for name in kernels},
        "launches_by_rank": [{k: e["kernel_launches"][k] for k in kernels}
                             for e in engines],
        "decode_step_ms_by_rank": [e["decode_step_ms"]["p50"]
                                   for e in engines],
        "peak_bytes_by_rank": [e.get("peak_bytes") for e in engines],
        "tokens_equal_on_every_rank": True,
        "f32": {**first["f32"],
                "max_abs_err": max(s["f32"]["max_abs_err"] for s in by_rank)}}


def tp_seq_summary(serve: list, cell: tuple, device) -> dict:
    """A cell of ``TP_SEQ_CELLS`` over the ranks, its gates checked: the
    tp served arch's (``tp_serve_summary``: tokens and gathered logits
    equal on every rank, each rank's launches as its prefills and steps
    give, the f32 logits), and where the cache splits by sequence, each
    rank's check of its run (``seq_split_check``) and its cache a
    ``1/m`` of one card's; the decode step's collectives a step."""
    key = seq_cell_key(*cell)
    arch, shape, shard_seq = cell
    out = tp_serve_summary(serve, key, device, arch)
    by_rank = [s[key] for s in serve]
    engines = [s["engine"] for s in by_rank]
    m = by_rank[0]["seq_ranks"]
    require(m == (shape[1] if shard_seq and arch == "gemma-2b" else 1),
            "tp/seq:", key, "split by sequence over", m, "ranks")
    # a rank's cache: its data rank's slots, and its model rank's KV heads
    # or run of the sequence: 1 / (data x model) of one card's (gemma-2b
    # over (1, 4): a quarter)
    require(all(s["kv_bytes"] * shape[0] * shape[1] == s["one_card_kv_bytes"]
                for s in by_rank), "tp/seq:", key, "a rank's cache",
            [s["kv_bytes"] for s in by_rank], "is not 1 /",
            shape[0] * shape[1], "of one card's",
            by_rank[0]["one_card_kv_bytes"])
    if m > 1:
        out["seq_check_by_rank"] = [s["check"]["seq"] for s in by_rank]
    steps = engines[0]["decode_steps"]
    dc = engines[0]["decode_collectives"]
    out.update({
        "mesh": list(shape), "shard_seq": shard_seq, "seq_ranks": m,
        "prefills_run_by_rank": [e["prefills_run"] for e in engines],
        "kv_bytes_a_rank": by_rank[0]["kv_bytes"],
        "one_card_kv_bytes": by_rank[0]["one_card_kv_bytes"],
        "decode_collectives": dc,
        "collectives_a_step": {
            "calls": sum(v["calls"] for v in dc.values()) / max(steps, 1),
            "seconds": sum(v["seconds"] for v in dc.values())
            / max(steps, 1)}})
    return out


def tp_train_summary(train: list, arch: str, n: int) -> dict:
    """One trained arch's results over the ranks, its gates checked."""
    full = [t[arch]["full"] for t in train]
    require(all(f["losses"] == full[0]["losses"] for f in full),
            "tp/train:", arch, "the ranks' losses differ")
    out = {**full[0], "step_ms_by_rank": [f["median_step_ms"] for f in full],
           "peak_bytes_by_rank": [f.get("peak_bytes") for f in full]}
    checks = [t[arch]["checks"] for t in train]
    saved = merged_digests([c.pop("saved_digests") for c in checks])
    onto = merged_digests([c.pop("restored_digests") for c in checks])
    one = merged_digests([checks[0].pop("one_digests")])
    steps = (saved.pop("step"), onto.pop("step"), one.pop("step"),
             {c["restored_step"] for c in checks}, {checks[0]["one_step"]})
    require(all(x == steps[0] and len(x) == 1 for x in steps),
            "tp/restore:", arch, "steps", steps)
    require(saved == onto, "tp/restore:", arch, "onto (1,", n,
            ") not bit-equal")
    require(saved == one, "tp/restore:", arch, "onto one rank not "
            "bit-equal")
    out["checks"] = {
        **checks[0], "restore": {
            "leaves": len(saved), "cells": sum(len(v) for v in
                                               saved.values()),
            "step": min(steps[0]), "saved_on": [2, n // 2],
            "onto": [[1, n], 1], "bit_equal": True},
        "save_seconds_by_rank": [c["save_seconds"] for c in checks]}
    return out


def phase_tp(sizes: Sizes, device: torch.device, seed: int,
             serve_archs: tuple = TP_SERVE_ARCHS,
             train_archs: tuple = TP_TRAIN_ARCHS,
             seq_cells: tuple = TP_SEQ_CELLS) -> dict:
    """Tensor parallelism over a ``"model"`` axis of 4 ranks on the one
    card under gloo (NCCL refuses two ranks on one card): (a) phi3-mini
    and granite-moe-3b served at full width and depth in bf16, each rank's
    flash and decode attention on its heads (8 of 32; 6 of 24 on 2 of 8
    KV heads), granite's experts 10 a rank, (b) their f32 logits at two
    layers against one rank's, (c) gemma-2b's and granite-moe-1b's
    full-width and full-depth train steps, step 1's loss against one
    card's, and (d) at two layers the f32 step leaf by leaf against one
    rank's (granite's experts chosen as the one-rank step chose them), a
    ZeRO-1 step over (2, 2), its checkpoint restored onto (1, 4) and one
    rank bit for bit; then (e) the cells of ``seq_cells`` in the same
    spawn as (a): gemma-2b served over (1, 4) with its cache split by
    sequence, phi3-mini over (2, 2) with its slots split over the data
    ranks (``tp_seq_one``).  Four ranks sharing one card measure
    correctness and each collective's cost, not scaling."""
    t0 = time.perf_counter()
    free(device)
    n = sizes.tp_ranks
    where = dist_device(device)
    out = {"phase": "tp", "ranks": n, "backend": "gloo",
           "rank_device": str(device), "mesh": [1, n]}
    if device.type == "cuda":
        _build.load()  # the ranks load the library this process built
    t1 = time.perf_counter()
    serve = ranks.spawn(tp_serve_rank, n, backend="gloo", device=where,
                        args=(sizes, seed, serve_archs, seq_cells),
                        timeout=TP_TIMEOUT_S, env=RANK_ENV)
    out["serve_seconds"] = time.perf_counter() - t1
    out["serve"] = {arch: tp_serve_summary(serve, arch, device)
                    for arch in serve_archs}
    out["seq"] = {seq_cell_key(*cell): tp_seq_summary(serve, cell, device)
                  for cell in seq_cells}
    out["seq_seconds"] = {k: v["seconds"] for k, v in out["seq"].items()}
    # the served archs' results now, in case a trained one fails below
    emit({"phase": "tp_serve", "seconds": out["serve_seconds"],
          "serve": out["serve"]})
    for key, cell in out["seq"].items():
        emit({"phase": "tp_seq", "cell": key, "mesh": cell["mesh"],
              "shard_seq": cell["shard_seq"],
              "decode_step_ms_p50": cell["decode_step_ms"]["p50"],
              "ttft_ms_p50": cell["ttft_ms"]["p50"],
              "ttft_ms_p90": cell["ttft_ms"]["p90"],
              "tokens_per_s": cell["tokens_per_s"],
              "staged_bytes": cell["staged_bytes"],
              "collective_calls_a_step":
                  cell["collectives_a_step"]["calls"],
              "collective_seconds_a_step":
                  cell["collectives_a_step"]["seconds"],
              "seconds": cell["seconds"]})
    out["train"] = {}
    if train_archs:
        with tempfile.TemporaryDirectory() as tmp:
            t1 = time.perf_counter()
            train = ranks.spawn(tp_train_rank, n, backend="gloo",
                                device=where,
                                args=(sizes, seed, tmp, train_archs),
                                timeout=TP_TIMEOUT_S, env=RANK_ENV)
            out["train_seconds"] = time.perf_counter() - t1
        out["train"] = {arch: tp_train_summary(train, arch, n)
                        for arch in train_archs}
    served = {**out["serve"], **out["seq"]}
    out["launches"] = {name: {arch: s["launches"][name]
                              for arch, s in served.items()
                              if name in s["launches"]}
                       for name in WRAPPERS}
    out["launches"] = {k: v for k, v in out["launches"].items() if v}
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    return out


# ---------------------------------------------------------------------------
# The dry run
# ---------------------------------------------------------------------------


def dry_cell(cfg, seq: int, batch: int, kind: str, mesh: dict,
             shard_seq: bool = False) -> dict:
    """One cell of this run's own shapes on the meta device, under
    ``tp``."""
    return dryrun.cell_metrics(cfg, ShapeSpec("chip_smoke", seq, batch, kind),
                               mesh, "tp", shard_seq=shard_seq)


def dry_cells(sizes: Sizes, flavor: str, mesh: dict, pool) -> dict:
    """Every cell of ``sizes.dryrun_archs`` (None: every arch) x shape over
    ``mesh`` under ``flavor``, each run in a process of ``pool``: the
    counts of each status, the seconds, each cell that ran by its dominant
    term, roofline fraction and bytes a rank, and the cells whose state a
    rank holds more bytes of than one card has (a finding, not a
    failure: under ``dp`` every rank holds the whole model)."""
    cells = [(a, s) for a in (sizes.dryrun_archs or ARCHS)
             for s in SHAPE_NAMES]
    with tempfile.TemporaryDirectory() as tmp:
        res = dryrun.run_cells(cells, mesh, flavor, tmp, pool=pool,
                               echo=False)
        failures = res.pop("failures")
        require(not failures, "dryrun:", flavor, "cells failed:",
                [f[0] for f in failures], failures[:1])
        ran = {}
        for name in sorted(os.listdir(tmp)):
            with open(os.path.join(tmp, name)) as f:
                art = json.load(f)
            if art.get("skipped"):
                continue
            r, mem = art["roofline"], art["memory"]
            ran[name[:-len(".json")]] = {
                "dominant": r["dominant"],
                "roofline_fraction": r["roofline_fraction"],
                "bytes_a_rank": mem["total_bytes"], "fits": mem["fits"],
                "run_s": art["run_s"]}
    return {**res, "cells_run": ran,
            "not_fitting": [k for k, c in ran.items() if not c["fits"]]}


def seq_dry_cells(sizes: Sizes, seq_cells: tuple = TP_SEQ_CELLS) -> dict:
    """The dry run's cell of each of ``seq_cells``: its decode step over
    its mesh (``shard_seq`` as the cell's) on ``tp_seq_slots`` slots
    (``dry_cell``'s arguments)."""
    out = {}
    for arch, shape, shard_seq in seq_cells:
        cfg = tp_config(arch, sizes.serve_smoke)
        out[seq_cell_key(arch, shape, shard_seq)] = (
            cfg, tp_serve_sizes(cfg, sizes)["max_len"], sizes.tp_seq_slots,
            "decode", {"data": shape[0], "model": shape[1]}, shard_seq)
    return out


def seq_dry_checks(seq: dict, metrics: dict) -> dict:
    """The exact checks of the ``tp`` phase's cells of ``TP_SEQ_CELLS``
    (``seq``) against their dry cells (``metrics``, by the same keys): a
    rank's params and cache bytes, and the ``collective:*`` spans of the
    engine's decode steps (calls and bytes) as the dry cell's step's times
    the steps."""
    out = {}
    for key, served in seq.items():
        m = metrics[key]
        got = {"params_bytes": m["memory"]["params_bytes"],
               "cache_bytes": m["memory"]["cache_bytes"]}
        want = {"params_bytes": served["local_param_bytes"],
                "cache_bytes": served["cache_bytes"]}
        require(got == want, "dryrun:", key, "a rank's bytes", got,
                "against the tp phase's", want)
        steps = served["decode_steps"]
        real = {k: {"calls": v["calls"], "bytes": v["bytes"]}
                for k, v in served["decode_collectives"].items()}
        want = {k: {"calls": v["calls"] * steps, "bytes": v["bytes"] * steps}
                for k, v in m["spans"].items()}
        require(real == want, "dryrun:", key, "decode-step collective "
                "spans", want, "against the tp phase's", steps, "steps'",
                real)
        out[key] = {**got, "spans_a_step": m["spans"],
                    "collectives_a_step": m["collectives"], "equal": True}
    return out


def dryrun_start(sizes: Sizes, processes: int,
                 serve_archs: tuple = TP_SERVE_ARCHS,
                 train_archs: tuple = TP_TRAIN_ARCHS,
                 seq_cells: tuple = TP_SEQ_CELLS) -> dict:
    """Start the dry run's host work on the meta device, which needs
    nothing of the card, over one pool of ``processes`` processes: the
    cells of this run's own shapes that ``phase_dryrun`` holds against the
    ``tp`` phase (``serve_archs``' decode caches and ``train_archs``' steps
    over (1, ``tp_ranks``), and the decode steps of ``seq_cells`` over
    their meshes) and the ``train`` phase (gemma-2b's step on one
    rank), then every cell of one pod under ``tp`` and ``dp`` (a thread
    each feeds the pool).  ``main`` starts it after the build, so that it
    runs on the cores the single-card phases leave idle; ``phase_dryrun``
    waits for it and ``dryrun_stop`` ends it."""
    t0 = time.perf_counter()
    mesh = make_production_mesh()
    on_tp = {"data": 1, "model": sizes.tp_ranks}
    cells = {}
    for arch in serve_archs:
        cfg = tp_config(arch, sizes.serve_smoke)
        cells["serve", arch] = (cfg, tp_serve_sizes(cfg, sizes)["max_len"],
                                sizes.serve_slots, "decode", on_tp)
    for arch in train_archs:
        cfg = tp_config(arch, sizes.train_smoke, attention_impl="xla")
        b, seq = tp_train_batch(cfg, sizes)
        cells["train", arch] = (cfg, seq, b, "train", on_tp)
    for key, args in seq_dry_cells(sizes, seq_cells).items():
        cells["seq", key] = args
    cells["roofline", None] = (train_config(sizes), sizes.train_seq,
                               sizes.train_batch, "train",
                               {"data": 1, "model": 1})
    procs = ProcessPoolExecutor(
        max_workers=processes,
        mp_context=multiprocessing.get_context("spawn"))
    threads = ThreadPoolExecutor(max_workers=2)
    return {"t0": t0, "mesh": mesh, "processes": processes,
            "procs": procs, "threads": threads, "cells": cells,
            "checks": {k: procs.submit(dry_cell, *a)
                       for k, a in cells.items()},
            "pod": {flavor: threads.submit(dry_cells, sizes, flavor, mesh,
                                           procs)
                    for flavor in ("tp", "dp")}}


def dryrun_stop(started: dict | None) -> None:
    """End a started dry run: the cells not begun dropped, the pools' threads
    and processes joined once their running cells end."""
    if started is None:
        return
    started["procs"].shutdown(wait=False, cancel_futures=True)
    started["threads"].shutdown(wait=True, cancel_futures=True)
    started["procs"].shutdown(wait=True)


def phase_dryrun(sizes: Sizes, tp: dict, train: dict,
                 started: dict | None = None) -> dict:
    """The dry run, host work on the meta device (the card idle; started
    by ``dryrun_start``, here where ``started`` is None, over a process a
    core): every cell of one pod under ``tp`` and ``dp`` with the PASS
    and SKIP counts and the seconds (the cells of the exact checks
    run beside them); then its exact checks against this run's card:
    (a) the ``tp`` phase's served cells over (1, 4): the params' bytes a
    rank that phase measured, and its engine's cache bytes a rank; (b)
    the ``tp`` phase's train steps: each ``collective:*`` span's calls and
    bytes as the real steps recorded them; (c) the roofline of the
    ``train`` phase's gemma-2b cell (one rank) beside its measured step
    time, as a roofline fraction; (d) the ``tp`` phase's cells over other
    meshes (gemma-2b's cache split by sequence over (1, 4), phi3-mini over
    (2, 2)): (a)'s bytes, and their decode steps' ``collective:*`` spans
    as (b) holds a train step's (``seq_dry_checks``)."""
    t0 = time.perf_counter()
    if started is None:
        started = dryrun_start(sizes, len(os.sched_getaffinity(0)),
                               tuple(tp["serve"]), tuple(tp["train"]),
                               tuple(c for c in TP_SEQ_CELLS
                                     if seq_cell_key(*c) in tp["seq"]))
    try:
        mesh = started["mesh"]
        out = {"phase": "dryrun", "device": "meta", "mesh": mesh,
               "paths": dryrun.PLAIN_PATHS,
               "processes": started["processes"]}
        for flavor, future in started["pod"].items():
            out[flavor] = future.result()
        metrics = {k: f.result() for k, f in started["checks"].items()}
        out["background_seconds"] = time.perf_counter() - started["t0"]
        out["wait_seconds"] = time.perf_counter() - t0
    finally:
        dryrun_stop(started)
    cells = started["cells"]
    require(set(tp["serve"]) == {a for k, a in cells if k == "serve"}
            and set(tp["train"]) == {a for k, a in cells if k == "train"}
            and set(tp["seq"]) == {a for k, a in cells if k == "seq"},
            "dryrun: started for other archs than the tp phase's")
    for arch, trained in tp["train"].items():
        _, seq, b = cells["train", arch][:3]
        require([b, seq] == trained["batch"], "dryrun:", arch, "cell of",
                [b, seq], "against the tp phase's batch", trained["batch"])
    b, seq = train["batch"]
    if [b, seq] != [sizes.train_batch, sizes.train_seq]:
        # the train phase halved its batch: that batch's cell
        metrics["roofline", None] = dry_cell(train_config(sizes), seq, b,
                                             "train", {"data": 1, "model": 1})
    out["tp_serve"] = {}
    for arch, served in tp["serve"].items():
        m = metrics["serve", arch]
        got = {"params_bytes": m["memory"]["params_bytes"],
               "cache_bytes": m["memory"]["cache_bytes"]}
        want = {"params_bytes": served["local_param_bytes"],
                "cache_bytes": served["cache_bytes"]}
        require(got == want, "dryrun:", arch, "a rank's bytes", got,
                "against the tp phase's", want)
        out["tp_serve"][arch] = {**got, "equal": True}
    out["tp_train"] = {}
    for arch, trained in tp["train"].items():
        steps = trained["steps"]
        m = metrics["train", arch]
        real = {k: {"calls": v["calls"], "bytes": v["bytes"]}
                for k, v in trained["collective_seconds"].items()}
        want = {k: {"calls": v["calls"] * steps, "bytes": v["bytes"] * steps}
                for k, v in m["spans"].items()}
        require(real == want, "dryrun:", arch, "collective spans",
                want, "against the tp phase's", steps, "steps'", real)
        out["tp_train"][arch] = {"spans_a_step": m["spans"],
                                 "collectives_a_step": m["collectives"],
                                 "equal": True}
    out["tp_seq"] = seq_dry_checks(tp["seq"], {
        key: metrics["seq", key] for key in tp["seq"]})
    cfg = train_config(sizes)
    m = metrics["roofline", None]
    roof = dryrun.cell_roofline(m)
    out["train_roofline"] = {"arch": cfg.name, "batch": [b, seq], **roof}
    step_ms = train.get("median_step_ms_3_to_10")
    if step_ms is not None:
        step_s = step_ms / 1e3
        out["train_roofline"].update({
            "measured_step_s": step_s,
            "measured_roofline_fraction":
                m["model_flops"] / ROOFLINE_PEAK_FLOPS / step_s,
            "bound_over_measured": roof["bound_time_s"] / step_s})
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rehearse", action="store_true",
                    help="toy sizes on the CPU with the plain versions; "
                         "measures nothing")
    args = ap.parse_args(argv)

    if args.rehearse:
        device, sizes = torch.device("cpu"), TOY
    else:
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device: this run needs one GPU",
                  file=sys.stderr)
            return 1
        device, sizes = torch.device("cuda", 0), FULL
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(args.seed)

    env = phase_env(device)
    build = phase_build(device)
    # The dry run: host work on the meta device over half the cores, from
    # here on beside the phases below, checked at the end against the tp
    # and train phases' measurements.
    started = dryrun_start(sizes,
                           max(1, len(os.sched_getaffinity(0)) // 2))
    # the mesh pass's inputs and one-worker results, for the ranks pass
    store = tempfile.mkdtemp(prefix="launch-store-")
    try:
        rows = phase_kernels(sizes, device, gen, build)

        # The launch and streaming path: every count set to 0 just before,
        # read just after.
        zero_counts()
        launch = phase_launch(sizes, device, gen, store)
        stream = phase_stream(sizes, device, args.seed)
        counts = {name: w.launches for name, w in WRAPPERS.items()}
        routes = route_counts()
        phase_sim(sizes, device, rows, stream)
        # Each serving run zeroes and reads the counts around its engine
        # run.
        serves = {arch: phase_serve(sizes, device, args.seed, arch)
                  for arch in SERVE_ARCHS}
        # The training path zeroes and reads the counts around its steps.
        train = phase_train(sizes, device, args.seed)
        # Each rank of the distribution phase zeroes and reads its own
        # counts around its flash-decode path, and reads them around each
        # application of the ranks pass.
        dist = phase_dist(sizes, device, args.seed, store, launch["mesh"])
        shutil.rmtree(store, ignore_errors=True)
        # Each rank of the tensor-parallel phase zeroes and reads its own
        # counts around its engine run.
        tp = phase_tp(sizes, device, args.seed)
        phase_dryrun(sizes, tp, train, started)
    finally:
        dryrun_stop(started)
        shutil.rmtree(store, ignore_errors=True)
    served = {arch: out["kernel_launches"] for arch, out in serves.items()}
    rwkv = served["rwkv6-3b"]
    hybrid = served["recurrentgemma-2b"]
    hybrid_routes = serves["recurrentgemma-2b"]["kernel_routes"]["rg_lru"]

    mesh = launch["mesh"]
    mesh_gemm = sum(mesh["gemm"].get("kernel_launches", {}).values())
    per_row = {
        "kmeans": counts["kmeans"], "hotspot": counts["hotspot"],
        "cluster_sums": counts["cluster_sums"],
        "gemm": launch["gemm"]["kernel_launches"] + mesh_gemm,
        "gemm_bf16": launch["gemm_bf16"]["kernel_launches"],
        "black_scholes": counts["black_scholes"],
        "spmv_ell": counts["spmv_ell"], "md5": counts["md5"],
        "nbody": counts["nbody"], "correlate": counts["correlate"],
        "flash_attention": sum(n["flash_attention"] for n in served.values())
        + sum(tp["launches"]["flash_attention"].values()),
        "decode_attention": sum(n["decode_attention"]
                                for n in served.values())
        + dist["decode_attention_launches"]
        + sum(tp["launches"]["decode_attention"].values()),
        "wkv6": rwkv["wkv6"] + sum(tp["launches"]["wkv6"].values()),
        "rg_lru": hybrid["rg_lru"] + sum(tp["launches"]["rg_lru"].values()),
    }
    require(per_row["gemm"] + per_row["gemm_bf16"] == counts["gemm"])
    # the ranks pass's launches, in the ranks of the dist phase
    over_ranks = dist["ranks_pass_launches"]
    on_nccl = dist.get("nccl_launches", {})
    in_parent = {name: per_row[name] for name in over_ranks}
    for name in over_ranks:
        per_row[name] += over_ranks[name] + on_nccl.get(name, 0)
    # The two kernels launched at more than one shape, split by shape.
    by_shape = {
        "kmeans": {"launch phase": launch["kmeans"]["kernel_launches"],
                   "mesh pass":
                   mesh["kmeans"].get("kernel_launches"),
                   "stream phase": stream.get("kernel_launches")},
        "rg_lru": {"prefills (route chunk)": hybrid_routes["chunk"],
                   "prefills and decode steps (route fma)":
                   hybrid_routes["fma"]},
        **{name: {arch: n[name] for arch, n in served.items() if n[name]}
           for name in ("flash_attention", "decode_attention")}}
    by_shape["decode_attention"]["dist phase"] = \
        dist["decode_attention_launches"]
    for name in over_ranks:
        by_shape.setdefault(name, {"launch phase and mesh pass":
                                   in_parent[name]})
        by_shape[name]["ranks pass (4 gloo ranks)"] = over_ranks[name]
        by_shape[name]["ranks pass (one NCCL rank)"] = on_nccl.get(name, 0)
    by_shape["wkv6"] = {"serve phase": rwkv["wkv6"]}
    for name, by_arch in tp["launches"].items():
        for arch, count in by_arch.items():
            label = arch if "@" in arch else f"{arch.split('-')[0]}_tp_rank"
            by_shape[name][f"tp phase (4 ranks, {label})"] = count
    for row in rows:
        row["launches"] = per_row[row["name"]]
        if row["name"] in by_shape:
            row["launches_by_shape"] = by_shape[row["name"]]
        if device.type == "cuda" and row["launches"] < 1:
            raise AssertionError(
                f"{row['name']}: the main path never launched this kernel")
    emit({"phase": "total", "seconds": time.perf_counter() - t0,
          "main_path_launches": counts, "main_path_routes": routes,
          "stream_launches": stream.get("kernel_launches"),
          "serve_launches": served,
          "train_launches": train["kernel_launches"],
          "dist_launches": {"decode_attention":
                            dist["decode_attention_launches"],
                            "ranks_pass": over_ranks,
                            "ranks_pass_nccl": on_nccl},
          "tp_launches": tp["launches"]})

    if args.rehearse:
        emit({"kernels": rows})
        emit({"ok": False, "rehearsal": True,
              "device": {"platform": "cpu", "kind": "cpu", "count": 0}})
        return 0
    emit({"kernels": rows})
    print(env["card"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

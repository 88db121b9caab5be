"""Assigned input shapes and per-(arch x shape) applicability.

Four shapes per LM architecture (seq_len x global_batch):

* ``train_4k``    4 096 x 256   — training step
* ``prefill_32k`` 32 768 x 32   — inference prefill
* ``decode_32k``  32 768 x 128  — one new token, 32k KV cache
* ``long_500k``   524 288 x 1   — long-context decode (sub-quadratic only)

``long_500k`` is SKIPPED for pure full-attention archs (quadratic attention
at 524 288 tokens) and RUNS for SSM/hybrid (rwkv6-3b, recurrentgemma-2b).
``input_specs`` returns tensors on the ``meta`` device: every input's
shape and dtype with no memory behind it, what the dry run
(``repro_torch.launch.dryrun``) feeds a step (the reference's
``jax.ShapeDtypeStruct`` stand-ins).  Tokens are int32, as the port's
models take them; frames and patch embeddings are in the config's dtype.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

SHAPE_NAMES = tuple(SHAPES)


def applicable(cfg: ModelConfig, shape_name: str) -> tuple[bool, str]:
    """(runs?, reason-if-skipped) for one (arch x shape) cell."""
    if shape_name == "long_500k" and not cfg.supports_long_context:
        return False, (
            "long_500k needs sub-quadratic attention; "
            f"{cfg.name} is pure full-attention (skip per assignment)"
        )
    return True, ""


def input_specs(cfg: ModelConfig, shape_name: str) -> dict:
    """``meta`` tensors standing in for every model input of this cell."""
    return spec_inputs(cfg, SHAPES[shape_name])


def spec_inputs(cfg: ModelConfig, spec: ShapeSpec) -> dict:
    """``input_specs`` for any ``ShapeSpec``, such as a cell cut to a
    smaller batch."""
    b, s = spec.global_batch, spec.seq_len

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    if spec.kind == "decode":  # one new token against a seq_len cache
        return {"tokens": meta((b, 1), torch.int32)}
    out = {"tokens": meta((b, s), torch.int32)}
    if cfg.family == "encdec":
        out["frames"] = meta((b, cfg.enc_frames, cfg.d_model),
                             cfg.torch_dtype)
    if cfg.family == "vlm":
        out["patch_embeds"] = meta((b, cfg.n_patches, cfg.d_model),
                                   cfg.torch_dtype)
    return out


def decode_cache_len(shape_name: str) -> int:
    return SHAPES[shape_name].seq_len

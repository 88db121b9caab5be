"""Model configuration for all assigned architecture families."""

from __future__ import annotations

import dataclasses

import torch

#: ``attention_impl`` values: the hand-written CUDA kernels, the eager
#: online-softmax version of ``xla_flash_attention``, the materialized oracle
ATTENTION_IMPLS = ("cuda", "xla", "naive")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | rwkv | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    vocab: int
    n_kv_heads: int | None = None
    head_dim: int | None = None
    activation: str = "swiglu"  # swiglu | geglu | gelu
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    expert_pad_to: int = 0
    moe_flat_dispatch: bool = False
    # Hybrid (RecurrentGemma): every `attn_every`-th block is local attention
    window: int | None = None
    attn_every: int = 0
    conv_width: int = 4
    # RWKV
    wkv_head_dim: int = 64
    # Enc-dec (Whisper)
    n_enc_layers: int = 0
    enc_frames: int = 1500
    # VLM
    n_patches: int = 0
    # Numerics / execution
    dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "nothing"
    # "cuda": the hand-written kernels, the production hot path (on a CPU
    # tensor their wrappers take the plain versions); "xla": eager
    # online-softmax attention; "naive": materialized-logits oracle.
    attention_impl: str = "cuda"
    kv_quant: bool = False  # int8 KV cache (serving)
    kv_fused: bool = True  # factor dequant scales out of the cache dots
    no_donate: bool = False
    scan_unroll: bool = False

    # -- derived -------------------------------------------------------------

    def __post_init__(self):
        if self.n_kv_heads is None:
            object.__setattr__(self, "n_kv_heads", self.n_heads)
        if self.head_dim is None:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.n_heads)
        if self.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"attention_impl {self.attention_impl!r} not in "
                             f"{ATTENTION_IMPLS}")

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "rwkv"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic sequence handling (SSM / hybrid-local-attention)."""
        return self.family in ("rwkv", "hybrid")

    def scaled(self, **kw) -> "ModelConfig":
        """A reduced copy for smoke tests (same family/topology)."""
        return dataclasses.replace(self, **kw)

"""stablelm-3b [hf:stabilityai/stablelm-2-*]: 32L, d_model 2560, 32H
(kv=32), d_ff 6912, vocab 50304.  RoPE + SwiGLU + LayerNorm (StableLM 2
uses LayerNorm)."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-3b",
        family="dense",
        n_layers=32,
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,
        d_ff=6912,
        vocab=50304,
        activation="swiglu",
        norm="layernorm",
        rope_theta=10_000.0,
    )


def smoke_config() -> ModelConfig:
    return config().scaled(
        name="stablelm-3b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=96, vocab=256,
        dtype="float32", remat=False,
    )

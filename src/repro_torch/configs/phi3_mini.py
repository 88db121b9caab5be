"""phi3-mini-3.8b [arXiv:2404.14219]: 32L, d_model 3072, 32H (GQA kv=32 —
full MHA), d_ff 8192, vocab 32064.  RoPE + SwiGLU."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi3-mini-3.8b",
        family="dense",
        n_layers=32,
        d_model=3072,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,
        vocab=32064,
        activation="swiglu",
        norm="rmsnorm",
        rope_theta=10_000.0,
    )


def smoke_config() -> ModelConfig:
    return config().scaled(
        name="phi3-mini-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=128, vocab=256,
        dtype="float32", remat=False,
    )

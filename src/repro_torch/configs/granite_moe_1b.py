"""granite-moe-1b-a400m [hf:ibm-granite/granite-3.0-1b-a400m-base]:
24L, d_model 1024, 16H (GQA kv=8), 32 experts top-8, d_expert 512,
vocab 49155.  RoPE + SwiGLU experts."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m",
        family="moe",
        n_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=8,
        d_ff=512,  # per-expert hidden
        vocab=49155,
        activation="swiglu",
        norm="rmsnorm",
        rope_theta=10_000.0,
        n_experts=32,
        top_k=8,
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return config().scaled(
        name="granite-moe-1b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=32, vocab=256, n_experts=4,
        top_k=2, dtype="float32", remat=False,
    )

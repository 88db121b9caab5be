"""granite-moe-3b-a800m [hf:ibm-granite/granite-3.0-3b-a800m-base]:
32L, d_model 1536, 24H (GQA kv=8), 40 experts top-8, d_expert 512,
vocab 49155.  RoPE + SwiGLU experts."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m",
        family="moe",
        n_layers=32,
        d_model=1536,
        n_heads=24,
        n_kv_heads=8,
        d_ff=512,  # per-expert hidden
        vocab=49155,
        activation="swiglu",
        norm="rmsnorm",
        rope_theta=10_000.0,
        n_experts=40,
        top_k=8,
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return config().scaled(
        name="granite-moe-3b-smoke", n_layers=2, d_model=48, n_heads=4,
        n_kv_heads=2, head_dim=12, d_ff=32, vocab=256, n_experts=5,
        top_k=2, dtype="float32", remat=False,
    )

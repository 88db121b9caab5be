"""gemma-2b [arXiv:2403.08295]: 18L, d_model 2048, 8H MQA (kv=1),
head_dim 256, d_ff 16384, GeGLU, vocab 256000, tied embeddings."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma-2b",
        family="dense",
        n_layers=18,
        d_model=2048,
        n_heads=8,
        n_kv_heads=1,
        head_dim=256,
        d_ff=16384,
        vocab=256_000,
        activation="geglu",
        norm="rmsnorm",
        rope_theta=10_000.0,
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return config().scaled(
        name="gemma-2b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=1, head_dim=32, d_ff=128, vocab=256,
        dtype="float32", remat=False,
    )

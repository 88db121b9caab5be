"""internvl2-26b [arXiv:2404.16821]: InternViT frontend (STUB — patch
embeddings provided by input_specs) + InternLM2 backbone: 48L, d_model 6144,
48H (GQA kv=8), d_ff 16384, vocab 92553.  RoPE + SwiGLU."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-26b",
        family="vlm",
        n_layers=48,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=16384,
        vocab=92553,
        activation="swiglu",
        norm="rmsnorm",
        rope_theta=1_000_000.0,
        n_patches=256,  # ViT patch embeddings prepended by the stub frontend
    )


def smoke_config() -> ModelConfig:
    return config().scaled(
        name="internvl2-26b-smoke", n_layers=2, d_model=64, n_heads=8,
        n_kv_heads=2, head_dim=8, d_ff=128, vocab=256, n_patches=8,
        dtype="float32", remat=False,
    )

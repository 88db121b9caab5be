"""recurrentgemma-2b [arXiv:2402.19427]: 26 blocks, d_model 2560, 10H MQA
(kv=1) head_dim 256, d_ff 7680 GeGLU, vocab 256000.  RG-LRU + local attention
(window 2048), pattern 1 attention per 2 recurrent.  Runs ``long_500k``."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b",
        family="hybrid",
        n_layers=26,
        d_model=2560,
        n_heads=10,
        n_kv_heads=1,
        head_dim=256,
        d_ff=7680,
        vocab=256_000,
        activation="geglu",
        norm="rmsnorm",
        rope_theta=10_000.0,
        window=2048,
        attn_every=3,  # (rec, rec, attn) groups
        conv_width=4,
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return config().scaled(
        name="recurrentgemma-2b-smoke", n_layers=8, d_model=64, n_heads=4,
        n_kv_heads=1, head_dim=16, d_ff=96, vocab=256, window=16,
        dtype="float32", remat=False,
    )

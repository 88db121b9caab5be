"""whisper-medium [arXiv:2212.04356]: enc-dec, 24L each side, d_model 1024,
16H, d_ff 4096, vocab 51865.  GELU + LayerNorm; conv frontend is a STUB
(input_specs provides precomputed frame embeddings, 1500 frames)."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium",
        family="encdec",
        n_layers=24,  # decoder
        n_enc_layers=24,
        enc_frames=1500,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_ff=4096,
        vocab=51865,
        activation="gelu",
        norm="layernorm",
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return config().scaled(
        name="whisper-medium-smoke", n_layers=2, n_enc_layers=2,
        enc_frames=16, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=256, dtype="float32", remat=False,
    )

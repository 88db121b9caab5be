"""rwkv6-3b "Finch" [arXiv:2404.05892]: 32L, d_model 2560 (attention-free),
d_ff 8960, vocab 65536.  WKV6 head_dim 64 → 40 heads.  Data-dependent decay.
Runs ``long_500k`` (O(1) state)."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b",
        family="rwkv",
        n_layers=32,
        d_model=2560,
        n_heads=40,  # d_model / wkv_head_dim
        d_ff=8960,
        vocab=65536,
        wkv_head_dim=64,
        norm="rmsnorm",
    )


def smoke_config() -> ModelConfig:
    return config().scaled(
        name="rwkv6-3b-smoke", n_layers=2, d_model=64, n_heads=4,
        d_ff=128, vocab=256, wkv_head_dim=16,
        dtype="float32", remat=False,
    )

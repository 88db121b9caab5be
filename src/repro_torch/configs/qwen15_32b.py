"""qwen1.5-32b [hf:Qwen/Qwen1.5-32B]: 64L, d_model 5120, 40H (kv=40, full
MHA at this size), d_ff 27392, vocab 152064.  QKV bias (the Qwen1.5
signature), RoPE + SwiGLU.

The config enables the int8 KV cache (serving): a bf16 cache of 64 layers
x 40 heads x 128 dims takes 1.3 MB a token, the int8 one half of that plus
its scales.  The smoke config inherits it.
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-32b",
        family="dense",
        n_layers=64,
        d_model=5120,
        n_heads=40,
        n_kv_heads=40,
        d_ff=27392,
        vocab=152064,
        activation="swiglu",
        norm="rmsnorm",
        qkv_bias=True,
        rope_theta=1_000_000.0,
        kv_quant=True,
    )


def smoke_config() -> ModelConfig:
    return config().scaled(
        name="qwen1.5-32b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=160, vocab=256,
        dtype="float32", remat=False,
    )

"""Model zoo: the assigned architectures, in PyTorch.

Every family of the reference: the dense decoder LMs (GQA/MQA
transformers: phi3, gemma, stablelm, qwen) and the InternVL backbone (VLM,
patch-embed stub), with their KV cache and attention (the hand-written
flash- and decode-attention kernels on the GPU); the granite MoE family
(the dense attention block, top-k routed experts with capacity-based
dispatch); RWKV-6 (the hand-written WKV6 kernel); the RecurrentGemma
hybrid (the hand-written RG-LRU kernel, local attention by the
flash-attention kernel); the Whisper encoder-decoder (conv frontend
stubbed; flash attention in the encoder and the decoder's prefill, decode
attention against the self- and cross-attention caches); and the
family-dispatched API the serving engine calls.
"""

from .api import decode_step, init_params, param_count, prefill, train_loss
from .config import ModelConfig

__all__ = [
    "ModelConfig", "init_params", "train_loss", "prefill", "decode_step",
    "param_count",
]

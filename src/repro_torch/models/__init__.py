"""Model zoo: the assigned architectures, in PyTorch.

Ported so far: the dense decoder LMs (GQA/MQA transformers: phi3, gemma,
stablelm, qwen) and the InternVL backbone (VLM, patch-embed stub), with
their KV cache and attention (the hand-written flash- and decode-attention
kernels on the GPU); RWKV-6 (the hand-written WKV6 kernel) and the
RecurrentGemma hybrid (the hand-written RG-LRU kernel, local attention by
the flash-attention kernel); and the family-dispatched API the serving
engine calls.  The MoE and Whisper families raise ``NotImplementedError``
naming their ROADMAP item.
"""

from .api import decode_step, init_params, param_count, prefill, train_loss
from .config import ModelConfig

__all__ = [
    "ModelConfig", "init_params", "train_loss", "prefill", "decode_step",
    "param_count",
]

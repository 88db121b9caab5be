"""Optimizer substrate: AdamW (and the ZeRO-1 axes of its state),
schedules, gradient compression."""

from .adamw import AdamWState, adamw_init, adamw_update, global_norm
from .compression import (
    ErrorFeedback,
    compress_int8,
    compressed_psum,
    decompress_int8,
)
from .schedule import cosine_with_warmup

__all__ = [
    "AdamWState", "adamw_init", "adamw_update", "global_norm",
    "cosine_with_warmup", "compress_int8", "decompress_int8",
    "compressed_psum", "ErrorFeedback",
]

"""``repro_torch.serve`` — the batched serving engine."""

from .engine import Request, ServeEngine

__all__ = ["Request", "ServeEngine"]

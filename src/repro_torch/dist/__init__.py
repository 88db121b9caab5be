"""``repro_torch.dist`` — distribution across ranks.  Only the one-device
``constrain`` so far (ROADMAP Queue A item 10 holds the rest)."""

from .sharding import constrain

__all__ = ["constrain"]

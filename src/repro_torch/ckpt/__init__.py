"""Checkpointing: async atomic save, retention, restore."""

from .checkpoint import CheckpointManager

__all__ = ["CheckpointManager"]

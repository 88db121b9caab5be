"""Checkpointing: async atomic save, retention, restore (also onto
another mesh of ranks)."""

from .checkpoint import CheckpointManager, restore_resharded

__all__ = ["CheckpointManager", "restore_resharded"]

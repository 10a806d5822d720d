"""Durable state: training-state checkpoints (``Checkpointer``,
``CheckpointManager``) and the BC round snapshot."""
from .checkpointer import DEFAULT_GENERATIONS, BCCheckpoint, CheckpointManager, Checkpointer

__all__ = ["Checkpointer", "CheckpointManager", "BCCheckpoint", "DEFAULT_GENERATIONS"]

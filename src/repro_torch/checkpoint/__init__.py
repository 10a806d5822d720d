"""Durable state of the BC round loop: the round snapshot."""
from .checkpointer import DEFAULT_GENERATIONS, BCCheckpoint

__all__ = ["BCCheckpoint", "DEFAULT_GENERATIONS"]

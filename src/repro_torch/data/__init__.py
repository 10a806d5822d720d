"""Synthetic input streams of the port (numpy, no device)."""
from .recsys import ClickLogStream

__all__ = ["ClickLogStream"]

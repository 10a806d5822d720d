"""Synthetic input streams of the port (numpy, no device) and the host
prefetcher."""
from .pipeline import Prefetcher
from .recsys import ClickLogStream

__all__ = ["ClickLogStream", "Prefetcher"]

"""Synthetic input streams of the port (numpy, no device) and the host
prefetcher."""
from .pipeline import Prefetcher
from .recsys import ClickLogStream
from .tokens import TokenStream

__all__ = ["ClickLogStream", "TokenStream", "Prefetcher"]

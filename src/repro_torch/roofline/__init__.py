"""Byte model of the 2-D engines: what each engine stores and streams per
device, the per-cell dense/BCSR choice and the memory guard's footprint.
No hardware constants: the card's capacity reaches the guard as an input."""
from .model import (
    TILE_OVERHEAD_BYTES,
    adjacency_stream_bytes,
    cell_kernel_choice,
    device_hbm_footprint,
    exchange_operands,
    sparse_tile_bytes,
)

__all__ = [
    "TILE_OVERHEAD_BYTES",
    "sparse_tile_bytes",
    "cell_kernel_choice",
    "exchange_operands",
    "adjacency_stream_bytes",
    "device_hbm_footprint",
]

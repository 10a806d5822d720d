"""The launch layout of the dense level kernels K1–K4: the column tile,
the operand scratch and the copy path of A that the pipelined main loop
of ``csrc/level_gemm.cuh`` takes for one launch.  Both
:mod:`~repro_torch.kernels.frontier_spmm` (K1/K3) and
:mod:`~repro_torch.kernels.dependency_spmm` (K2/K4) use it.
"""
from __future__ import annotations

import torch

__all__ = ["COLUMN_TILES", "column_tile", "operand_stride", "fast_copies", "operand_layout"]

#: column tiles of the main loop, one instantiation each (the cases of
#: ``dispatch`` in csrc/level_gemm.cuh)
COLUMN_TILES = (64, 128, 192)


def column_tile(s: int) -> int:
    """The column tile for width ``s``: the fewest padded columns
    ⌈s/BS⌉·BS, ties to the wider tile (fewer passes over A).  s = 128 and
    s = 192, the main path's widths, get a tile of their own width."""
    return min(COLUMN_TILES, key=lambda bs: (-(-s // bs) * bs, -bs))


def operand_stride(s: int) -> int:
    """Row stride of the operand scratch: s rounded up to 4 floats, so that
    every row is 16-byte aligned for the main loop's copies."""
    return -(-s // 4) * 4


def fast_copies(adjacency: torch.Tensor) -> bool:
    """Whether A's rows are 16-byte aligned (base and row length), so that
    the main loop may copy A in 16-byte chunks; otherwise it takes the
    instantiation that loads A element by element."""
    row_bytes = adjacency.shape[1] * adjacency.element_size()
    return row_bytes % 16 == 0 and adjacency.data_ptr() % 16 == 0


def operand_layout(
    adjacency: torch.Tensor, sigma: torch.Tensor
) -> tuple[torch.Tensor, int, int, int]:
    """(operand scratch [k, ld], ld, column tile, fast) of one launch; the
    kernel's operand pass fills the scratch, pad columns included."""
    k, s = sigma.shape
    ld = operand_stride(s)
    operand = torch.empty((k, ld), dtype=torch.float32, device=sigma.device)
    return operand, ld, column_tile(s), int(fast_copies(adjacency))

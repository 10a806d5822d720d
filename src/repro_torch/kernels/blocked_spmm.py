"""K5 and K6 — the blocked-sparse (BCSR) pre-fold partials of a forward
and a dependency level — launched on the card.

K5 replaces ``kernels/blocked_spmm.py:frontier_sparse_kernel`` /
``frontier_sparse_acc_kernel`` of the JAX package (Pallas TPU kernels),
K6 ``dependency_sparse_kernel`` / ``dependency_sparse_acc_kernel``; both
are ``csrc/sparse_spmm.cu``, over the shared main loop of
``csrc/level_tile.cuh``.  The note in the source gives the bound (f32
compute) and the design: one thread block per (tile-row, 128-column)
output tile walks that tile-row's run of the row-sorted tile list, found
through a CSR ``row_ptr`` (:func:`tile_row_ptr`).  The plain versions are
:func:`repro_torch.kernels.ref.frontier_sparse_ref` and
:func:`~repro_torch.kernels.ref.dependency_sparse_ref`; the public,
checked entry points are :func:`repro_torch.kernels.ops.frontier_spmm_sparse`
and :func:`~repro_torch.kernels.ops.dependency_spmm_sparse`.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["tile_row_ptr", "frontier_sparse_cuda", "dependency_sparse_cuda"]


def tile_row_ptr(tile_rows: torch.Tensor, num_tile_rows: int) -> torch.Tensor:
    """i32 [num_tile_rows + 1] CSR row pointer of a row-sorted tile list:
    tile-row r owns tiles ``[row_ptr[r], row_ptr[r + 1])``.  Built once per
    layout (the operators cache it), never once per level."""
    bounds = torch.arange(num_tile_rows + 1, dtype=tile_rows.dtype, device=tile_rows.device)
    return torch.searchsorted(tile_rows, bounds).to(torch.int32)


def _launch(name: str, fn, tiles, tile_cols, row_ptr, operands, acc, m: int, kdim: int,
            s: int, lvl: int) -> torch.Tensor:
    _, bm, bk = tiles.shape
    dev = tiles.device
    t_out = torch.empty((m, s), dtype=torch.float32, device=dev)
    err = fn(
        tiles.data_ptr(), tile_cols.data_ptr(), row_ptr.data_ptr(),
        *(x.data_ptr() for x in operands), None if acc is None else acc.data_ptr(),
        t_out.data_ptr(), m, kdim, s, bm, bk, int(lvl),
        dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return t_out


def frontier_sparse_cuda(
    tiles: torch.Tensor,
    tile_cols: torch.Tensor,
    row_ptr: torch.Tensor,
    sigma: torch.Tensor,
    depth: torch.Tensor,
    lvl: int,
    m: int,
    acc: torch.Tensor | None,
) -> torch.Tensor:
    """Launch K5 on already-validated CUDA tensors (see
    ops.frontier_spmm_sparse): t = [acc +] Σ_tiles A_tile @ (σ ⊙ [d = lvl-1])."""
    kdim, s = sigma.shape
    return _launch("frontier_spmm_sparse", _build.library().frontier_sparse_f32, tiles,
                   tile_cols, row_ptr, (sigma, depth), acc, m, kdim, s, lvl)


def dependency_sparse_cuda(
    tiles: torch.Tensor,
    tile_cols: torch.Tensor,
    row_ptr: torch.Tensor,
    sigma: torch.Tensor,
    depth: torch.Tensor,
    delta: torch.Tensor,
    omega: torch.Tensor,
    lvl: int,
    m: int,
    acc: torch.Tensor | None,
) -> torch.Tensor:
    """Launch K6 on already-validated CUDA tensors (see
    ops.dependency_spmm_sparse): t = [acc +] Σ_tiles A_tile @ g."""
    kdim, s = sigma.shape
    return _launch("dependency_spmm_sparse", _build.library().dependency_sparse_f32, tiles,
                   tile_cols, row_ptr, (sigma, depth, delta, omega), acc, m, kdim, s, lvl)

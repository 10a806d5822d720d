"""K2 — the fused backward dependency level kernel — and K4 — its
pre-fold partial on a rectangular 2-D block — launched on the card.

K2 replaces ``kernels/dependency_spmm.py:dependency_spmm_kernel`` of the
JAX package (a Pallas TPU kernel); its CUDA source is
``csrc/dependency_spmm.cu``.  K4 replaces ``dependency_partial_kernel`` /
``dependency_partial_acc_kernel`` of the same file; its source is the
dependency half of ``csrc/partial_spmm.cu``.  Each launch is two kernels:
the operand pass of ``csrc/level_operand.cuh`` writes
g = (1 + δ + ω) / σ̂ once into a [k, ld] f32 scratch that the wrapper
allocates here (ld = s rounded up to 4), then the
pipelined f32 main loop of ``csrc/level_gemm.cuh`` multiplies A by it, at
the column tile :func:`~repro_torch.kernels.level_gemm.column_tile` picks
from s and with 16-byte copies of A where
:func:`~repro_torch.kernels.level_gemm.fast_copies` allows them (the
layout helpers live in :mod:`~repro_torch.kernels.level_gemm`, shared with
K1/K3, and stay importable from here).  The notes in the sources give
the bound (f32 compute) and the design.  The plain versions are
:func:`repro_torch.kernels.ref.dependency_spmm_ref` and
:func:`~repro_torch.kernels.ref.dependency_partial_ref`; the public,
checked entry points are :func:`repro_torch.kernels.ops.dependency_spmm`
and :func:`~repro_torch.kernels.ops.dependency_spmm_partial`.
"""
from __future__ import annotations

import torch

from . import _build
from .level_gemm import COLUMN_TILES, column_tile, fast_copies, operand_layout, operand_stride

__all__ = [
    "COLUMN_TILES",
    "column_tile",
    "operand_stride",
    "fast_copies",
    "dependency_spmm_cuda",
    "dependency_partial_cuda",
]


def dependency_spmm_cuda(
    adjacency: torch.Tensor,
    sigma: torch.Tensor,
    depth: torch.Tensor,
    delta: torch.Tensor,
    omega: torch.Tensor,
    lvl: int,
) -> torch.Tensor:
    """Launch K2 on already-validated CUDA tensors (see ops.dependency_spmm).

    Allocates the output and the operand scratch, launches on the current
    stream without synchronising, and raises if the launch was refused."""
    n, s = sigma.shape
    delta_out = torch.empty_like(delta)
    operand, ld, bs, fast = operand_layout(adjacency, sigma)
    lib = _build.library()
    fn = (
        lib.dependency_spmm_bf16
        if adjacency.dtype == torch.bfloat16
        else lib.dependency_spmm_f32
    )
    err = fn(
        adjacency.data_ptr(), sigma.data_ptr(), depth.data_ptr(),
        delta.data_ptr(), omega.data_ptr(), delta_out.data_ptr(), operand.data_ptr(),
        n, s, ld, int(lvl), bs, fast,
        sigma.device.index, torch.cuda.current_stream(sigma.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"dependency_spmm kernel launch failed: CUDA error {err}")
    return delta_out


def dependency_partial_cuda(
    adjacency: torch.Tensor,
    sigma: torch.Tensor,
    depth: torch.Tensor,
    delta: torch.Tensor,
    omega: torch.Tensor,
    lvl: int,
    acc: torch.Tensor | None,
) -> torch.Tensor:
    """Launch K4 on already-validated CUDA tensors (see
    ops.dependency_spmm_partial): t = [acc +] A_blk @ g."""
    m, kdim = adjacency.shape
    s = sigma.shape[1]
    t_out = torch.empty((m, s), dtype=torch.float32, device=sigma.device)
    operand, ld, bs, fast = operand_layout(adjacency, sigma)
    lib = _build.library()
    fn = (
        lib.dependency_partial_bf16
        if adjacency.dtype == torch.bfloat16
        else lib.dependency_partial_f32
    )
    err = fn(
        adjacency.data_ptr(), sigma.data_ptr(), depth.data_ptr(), delta.data_ptr(),
        omega.data_ptr(), None if acc is None else acc.data_ptr(), t_out.data_ptr(),
        operand.data_ptr(), m, kdim, s, ld, int(lvl), bs, fast,
        sigma.device.index, torch.cuda.current_stream(sigma.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"dependency_spmm_partial kernel launch failed: CUDA error {err}")
    return t_out

"""K1 — the fused forward BFS level kernel — and K3 — its pre-fold partial
on a rectangular 2-D block — launched on the card.

K1 replaces ``kernels/frontier_spmm.py:frontier_spmm_kernel`` of the JAX
package (a Pallas TPU kernel); its CUDA source is ``csrc/frontier_spmm.cu``.
K3 replaces ``frontier_partial_kernel`` / ``frontier_partial_acc_kernel``
of the same file; its source is the frontier half of
``csrc/partial_spmm.cu``.  Each launch is two kernels, as K2/K4's are: the
operand pass of ``csrc/level_operand.cuh`` writes the masked frontier
σ ⊙ [d = lvl-1] once into a [k, ld] f32 scratch that the wrapper
allocates here, then the pipelined f32 main loop of
``csrc/level_gemm.cuh`` multiplies A by it, at the column tile and copy
path that :func:`~repro_torch.kernels.level_gemm.operand_layout` picks.
The notes in the sources give the bound (f32 compute) and the design.
The plain versions are :func:`repro_torch.kernels.ref.frontier_spmm_ref`
and :func:`~repro_torch.kernels.ref.frontier_partial_ref`; the public,
checked entry points are :func:`repro_torch.kernels.ops.frontier_spmm` and
:func:`~repro_torch.kernels.ops.frontier_spmm_partial`.
"""
from __future__ import annotations

import torch

from . import _build
from .level_gemm import operand_layout

__all__ = ["frontier_spmm_cuda", "frontier_partial_cuda"]


def frontier_spmm_cuda(
    adjacency: torch.Tensor, sigma: torch.Tensor, depth: torch.Tensor, lvl: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K1 on already-validated CUDA tensors (see ops.frontier_spmm).

    Allocates the outputs and the operand scratch, launches on the current
    stream without synchronising, and raises if the launch was refused."""
    n, s = sigma.shape
    sigma_out = torch.empty_like(sigma)
    depth_out = torch.empty_like(depth)
    operand, ld, bs, fast = operand_layout(adjacency, sigma)
    lib = _build.library()
    fn = lib.frontier_spmm_bf16 if adjacency.dtype == torch.bfloat16 else lib.frontier_spmm_f32
    err = fn(
        adjacency.data_ptr(), sigma.data_ptr(), depth.data_ptr(),
        sigma_out.data_ptr(), depth_out.data_ptr(), operand.data_ptr(),
        n, s, ld, int(lvl), bs, fast,
        sigma.device.index, torch.cuda.current_stream(sigma.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"frontier_spmm kernel launch failed: CUDA error {err}")
    return sigma_out, depth_out


def frontier_partial_cuda(
    adjacency: torch.Tensor,
    sigma: torch.Tensor,
    depth: torch.Tensor,
    lvl: int,
    acc: torch.Tensor | None,
) -> torch.Tensor:
    """Launch K3 on already-validated CUDA tensors (see
    ops.frontier_spmm_partial): t = [acc +] A_blk @ (σ ⊙ [d = lvl-1])."""
    m, kdim = adjacency.shape
    s = sigma.shape[1]
    t_out = torch.empty((m, s), dtype=torch.float32, device=sigma.device)
    operand, ld, bs, fast = operand_layout(adjacency, sigma)
    lib = _build.library()
    fn = (
        lib.frontier_partial_bf16
        if adjacency.dtype == torch.bfloat16
        else lib.frontier_partial_f32
    )
    err = fn(
        adjacency.data_ptr(), sigma.data_ptr(), depth.data_ptr(),
        None if acc is None else acc.data_ptr(), t_out.data_ptr(), operand.data_ptr(),
        m, kdim, s, ld, int(lvl), bs, fast,
        sigma.device.index, torch.cuda.current_stream(sigma.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"frontier_spmm_partial kernel launch failed: CUDA error {err}")
    return t_out

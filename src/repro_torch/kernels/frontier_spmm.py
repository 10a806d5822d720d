"""K1 — the fused forward BFS level kernel — and K3 — its pre-fold partial
on a rectangular 2-D block — launched on the card.

K1 replaces ``kernels/frontier_spmm.py:frontier_spmm_kernel`` of the JAX
package (a Pallas TPU kernel); its CUDA source is ``csrc/frontier_spmm.cu``.
K3 replaces ``frontier_partial_kernel`` / ``frontier_partial_acc_kernel``
of the same file; its source is ``csrc/partial_spmm.cu``.  Both run over
the shared tiled main loop of ``csrc/level_tile.cuh``; the notes in the
sources give the bound (f32 compute) and the design.  The plain versions
are :func:`repro_torch.kernels.ref.frontier_spmm_ref` and
:func:`~repro_torch.kernels.ref.frontier_partial_ref`; the public, checked
entry points are :func:`repro_torch.kernels.ops.frontier_spmm` and
:func:`~repro_torch.kernels.ops.frontier_spmm_partial`.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["frontier_spmm_cuda", "frontier_partial_cuda"]


def frontier_spmm_cuda(
    adjacency: torch.Tensor, sigma: torch.Tensor, depth: torch.Tensor, lvl: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K1 on already-validated CUDA tensors (see ops.frontier_spmm).

    Allocates the outputs, launches on the current stream without
    synchronising, and raises if the launch was refused."""
    n, s = sigma.shape
    sigma_out = torch.empty_like(sigma)
    depth_out = torch.empty_like(depth)
    lib = _build.library()
    fn = lib.frontier_spmm_bf16 if adjacency.dtype == torch.bfloat16 else lib.frontier_spmm_f32
    err = fn(
        adjacency.data_ptr(), sigma.data_ptr(), depth.data_ptr(),
        sigma_out.data_ptr(), depth_out.data_ptr(), n, s, int(lvl),
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
    lib = _build.library()
    fn = (
        lib.frontier_partial_bf16
        if adjacency.dtype == torch.bfloat16
        else lib.frontier_partial_f32
    )
    err = fn(
        adjacency.data_ptr(), sigma.data_ptr(), depth.data_ptr(),
        None if acc is None else acc.data_ptr(), t_out.data_ptr(), m, kdim, s, int(lvl),
        sigma.device.index, torch.cuda.current_stream(sigma.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"frontier_spmm_partial kernel launch failed: CUDA error {err}")
    return t_out

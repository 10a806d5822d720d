"""K1 — the fused forward BFS level kernel, launched on the card.

Replaces ``kernels/frontier_spmm.py:frontier_spmm_kernel`` of the JAX
package (a Pallas TPU kernel).  The CUDA source is
``csrc/frontier_spmm.cu`` over the shared tiled main loop of
``csrc/level_tile.cuh``; its note gives the bound (f32 compute) and the
design.  The plain version is :func:`repro_torch.kernels.ref.frontier_spmm_ref`;
the public, checked entry point is :func:`repro_torch.kernels.ops.frontier_spmm`.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["frontier_spmm_cuda"]


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

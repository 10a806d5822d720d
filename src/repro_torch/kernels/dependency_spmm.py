"""K2 — the fused backward dependency level kernel, launched on the card.

Replaces ``kernels/dependency_spmm.py:dependency_spmm_kernel`` of the JAX
package (a Pallas TPU kernel).  The CUDA source is
``csrc/dependency_spmm.cu`` over the shared tiled main loop of
``csrc/level_tile.cuh``; its note gives the bound (f32 compute) and the
design.  The plain version is
:func:`repro_torch.kernels.ref.dependency_spmm_ref`; the public, checked
entry point is :func:`repro_torch.kernels.ops.dependency_spmm`.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["dependency_spmm_cuda"]


def dependency_spmm_cuda(
    adjacency: torch.Tensor,
    sigma: torch.Tensor,
    depth: torch.Tensor,
    delta: torch.Tensor,
    omega: torch.Tensor,
    lvl: int,
) -> torch.Tensor:
    """Launch K2 on already-validated CUDA tensors (see ops.dependency_spmm).

    Allocates the output, launches on the current stream without
    synchronising, and raises if the launch was refused."""
    n, s = sigma.shape
    delta_out = torch.empty_like(delta)
    lib = _build.library()
    fn = (
        lib.dependency_spmm_bf16
        if adjacency.dtype == torch.bfloat16
        else lib.dependency_spmm_f32
    )
    err = fn(
        adjacency.data_ptr(), sigma.data_ptr(), depth.data_ptr(),
        delta.data_ptr(), omega.data_ptr(), delta_out.data_ptr(), n, s, int(lvl),
        sigma.device.index, torch.cuda.current_stream(sigma.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"dependency_spmm kernel launch failed: CUDA error {err}")
    return delta_out

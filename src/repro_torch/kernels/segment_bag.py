"""K7 — the EmbeddingBag (sum) kernel of the DLRM lookup — launched on the
card.

K7 replaces ``kernels/segment_bag.py:segment_bag_kernel`` of the JAX
package (a Pallas TPU kernel); its CUDA source is ``csrc/segment_bag.cu``,
whose note gives the bound (bytes) and the design: one group of threads
per bag, vectorised 16-byte row loads, f32 register sums, one store per
bag.  The plain version is :func:`repro_torch.kernels.ref.segment_bag_ref`;
the public, checked entry point is :func:`repro_torch.kernels.ops.segment_bag`.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["segment_bag_cuda"]


def segment_bag_cuda(
    table: torch.Tensor, indices: torch.Tensor, weights: torch.Tensor | None
) -> torch.Tensor:
    """Launch K7 on already-validated CUDA tensors (see ops.segment_bag):
    out f32 [B, D], out[b] = Σ_l w[b,l]·table[indices[b,l]]."""
    num_bags, bag_len = indices.shape
    d = table.shape[1]
    out = torch.empty((num_bags, d), dtype=torch.float32, device=table.device)
    lib = _build.library()
    fn = lib.segment_bag_bf16 if table.dtype == torch.bfloat16 else lib.segment_bag_f32
    err = fn(
        table.data_ptr(), indices.data_ptr(), None if weights is None else weights.data_ptr(),
        out.data_ptr(), num_bags, bag_len, d,
        table.device.index, torch.cuda.current_stream(table.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"segment_bag kernel launch failed: CUDA error {err}")
    return out

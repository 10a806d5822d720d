"""Gradient compression: int8 block quantization with error feedback.

The port of the JAX package's ``distributed/compression.py``.  For
data-parallel all-reduces the gradient payload dominates the collective
term; int8 + per-block scales cuts it 4x.  Error feedback (Seide et al.
/ EF-SGD) accumulates the quantization residual locally and re-adds it
the next step, which preserves convergence.  ``torch.round`` rounds half
to even, as ``jnp.round`` does, so the payload and the scales equal the
reference's bit for bit.

Usage (train loop; trees are dicts of tensors, nested or flat):
    carrier, residual = compress_tree(grads, residual)
    grads = decompress_tree(carrier)              # after the all-reduce
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

__all__ = ["QuantizedTensor", "quantize", "dequantize", "compress_tree", "decompress_tree",
           "init_residual", "BLOCK"]

BLOCK = 256


class QuantizedTensor(NamedTuple):
    q: torch.Tensor  # int8 payload, padded flat [ceil(n/B), B]
    scale: torch.Tensor  # f32 per-block scales [ceil(n/B)]
    shape: tuple  # original shape


def quantize(x: torch.Tensor) -> QuantizedTensor:
    shape = tuple(x.shape)
    flat = x.to(torch.float32).reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % BLOCK))
    blocks = flat.reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1) / 127.0
    safe = torch.where(scale > 0, scale, 1.0)
    q = torch.clamp(torch.round(blocks / safe[:, None]), -127, 127).to(torch.int8)
    return QuantizedTensor(q=q, scale=scale, shape=shape)


def dequantize(t: QuantizedTensor) -> torch.Tensor:
    flat = (t.q.to(torch.float32) * t.scale[:, None]).reshape(-1)
    n = 1
    for d in t.shape:
        n *= d
    return flat[:n].reshape(t.shape)


def _map(fn, tree):
    """``fn`` over the leaves of a (nested) dict; a QuantizedTensor is a leaf."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def init_residual(tree: Any) -> Any:
    return _map(lambda x: torch.zeros(x.shape, dtype=torch.float32, device=x.device), tree)


def compress_tree(grads: Any, residual: Any) -> tuple[Any, Any]:
    """Returns (quantized tree, new residual).  Error feedback: the next
    step's gradient carries this step's quantization error."""
    if isinstance(grads, dict):
        pairs = {k: compress_tree(grads[k], residual[k]) for k in grads}
        return {k: q for k, (q, _) in pairs.items()}, {k: r for k, (_, r) in pairs.items()}
    corrected = grads.to(torch.float32) + residual
    qt = quantize(corrected)
    return qt, corrected - dequantize(qt)


def decompress_tree(qtree: Any) -> Any:
    return _map(dequantize, qtree)

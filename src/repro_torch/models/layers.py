"""Shared neural-net building blocks of the port."""
from __future__ import annotations

import torch

__all__ = ["dense_init_"]


def dense_init_(tensor: torch.Tensor, generator: torch.Generator, in_axis: int = 0) -> torch.Tensor:
    """Truncated-normal fan-in init, in place: N(0, 1) truncated to
    [-2, 2], scaled by fan_in^-1/2 with fan_in = ``tensor.shape[in_axis]``
    (the JAX package's ``dense_init``; an ``nn.Linear`` weight is
    [out, in], so it passes ``in_axis=1``).  ``generator`` lies on the
    tensor's device, so the weights are drawn where they live."""
    std = tensor.shape[in_axis] ** -0.5
    with torch.no_grad():
        torch.nn.init.trunc_normal_(tensor, 0.0, 1.0, -2.0, 2.0, generator=generator)
        return tensor.mul_(std)

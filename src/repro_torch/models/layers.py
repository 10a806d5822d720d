"""Shared neural-net building blocks of the port.

The LM blocks are the JAX package's ``models/layers.py`` in torch: the
same operations in the same dtypes (f32 inside the norm and the rotary
embedding, the result cast back to the input's dtype).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["dense_init_", "rms_norm", "rope", "rope_frequencies", "rope_tables", "apply_rope",
           "swiglu", "geglu", "ACTIVATIONS"]


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


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x · rsqrt(mean(x²) + eps) · (1 + scale), in f32, cast back to x's dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float = 1e4) -> torch.Tensor:
    """f32 [head_dim // 2]: theta^(-i / half), computed in float64 and
    rounded once.  An f32 ``pow`` is off by an ulp in a few per cent of
    the entries, and at position 524 287 one ulp of a frequency moves the
    angle by ~0.03 rad; the rounded float64 value is the correctly rounded
    f32 one, which is what the JAX package's f32 ``**`` gives."""
    half = head_dim // 2
    return (theta ** (-torch.arange(half, dtype=torch.float64) / half)).to(torch.float32)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float = 1e4,
                freq: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) f32 [..., seq, 1, head_dim // 2] of the rotary angles
    position × frequency (f32 product) at ``positions`` [..., seq]; one
    pair serves every layer's q and k at those positions.  ``freq``:
    :func:`rope_frequencies` already on the positions' device."""
    if freq is None:
        freq = rope_frequencies(head_dim, theta).to(positions.device)
    angles = positions[..., None].to(torch.float32) * freq  # [..., seq, half]
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotary embedding, half-split form (the first half of head_dim
    rotates against the second, not interleaved pairs), in f32, cast back.
    x: [..., seq, n_heads, head_dim]; cos / sin from :func:`rope_tables`."""
    half = x.shape[-1] // 2
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4) -> torch.Tensor:
    """Rotary embedding of x [..., seq, n_heads, head_dim] at ``positions``
    [..., seq] (integers): the JAX package's ``rope``."""
    return apply_rope(x, *rope_tables(positions, x.shape[-1], theta))


def swiglu(gate_up: torch.Tensor) -> torch.Tensor:
    gate, up = gate_up.chunk(2, dim=-1)
    return F.silu(gate) * up


def geglu(gate_up: torch.Tensor) -> torch.Tensor:
    gate, up = gate_up.chunk(2, dim=-1)
    return F.gelu(gate, approximate="tanh") * up


ACTIVATIONS = {"silu": swiglu, "gelu": geglu}

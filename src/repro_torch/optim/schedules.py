"""Learning-rate schedules: plain functions of an integer step.

The port of the JAX package's ``optim/schedules.py``.  Each schedule
computes in float32, as the reference does, and returns a Python float
that holds that float32 value, so that both packages use the same
learning rate step for step.
"""
from __future__ import annotations

import math

import torch

__all__ = ["constant", "linear_warmup", "cosine_with_warmup"]


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def constant(value: float):
    lr = float(_f32(value))
    return lambda step: lr


def linear_warmup(peak: float, warmup_steps: int):
    def fn(step: int) -> float:
        step = _f32(step)
        return float(peak * torch.clamp(step / max(warmup_steps, 1), max=1.0))

    return fn


def cosine_with_warmup(peak: float, warmup_steps: int, total_steps: int, floor: float = 0.0):
    def fn(step: int) -> float:
        step = _f32(step)
        warm = peak * torch.clamp(step / max(warmup_steps, 1), max=1.0)
        prog = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = floor + (peak - floor) * 0.5 * (1.0 + torch.cos(math.pi * prog))
        return float(torch.where(step < warmup_steps, warm, cos))

    return fn

"""LM training launcher of the port — for now only :func:`reduced_lm`.

``serve_lm --reduced`` and the tests shrink an LM config with it, as the
JAX package's ``launch/train.py`` does.  ``train_lm`` and the training
command line come with the LM training slice (ROADMAP Queue 1 item 12).
"""
from __future__ import annotations

import dataclasses

from ..configs.base import LMArch

__all__ = ["reduced_lm"]


def reduced_lm(arch: LMArch, layers: int, d_model: int, vocab: int) -> LMArch:
    """Shrink an LM config for CPU-scale runs, preserving its character
    (GQA ratio, MoE-ness, activation): the JAX package's ``reduced_lm``."""
    head_dim = 64
    n_heads = max(2, d_model // 128)
    n_kv = max(1, min(arch.n_kv_heads, n_heads))
    moe = None
    if arch.moe is not None:
        moe = dataclasses.replace(
            arch.moe, num_experts=min(arch.moe.num_experts, 8), d_ff=d_model * 2
        )
    return dataclasses.replace(
        arch,
        n_layers=layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=head_dim,
        d_ff=d_model * 4,
        vocab=vocab,
        moe=moe,
        q_chunk=128,
        loss_chunk=128,
    )

"""Gemma-7B dense LM (arXiv:2403.08295; hf tier).

28L d_model=3072 16H (GQA kv=16, head_dim=256) d_ff=24576 GeGLU,
vocab=256000.  Note head_dim*heads (4096) != d_model (3072) — the o-proj
maps back.
"""
from .base import LM_SHAPES, LMArch
from .registry import register

ARCH = LMArch(
    name="gemma-7b",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab=256000,
    activation="gelu",
)

register(ARCH, LM_SHAPES)

"""DeepSeek-Coder-33B dense LM (arXiv:2401.14196; hf tier).

62L d_model=7168 56H (GQA kv=8, head_dim=128) d_ff=19200 vocab=32256,
llama-style SwiGLU.
"""
from .base import LM_SHAPES, LMArch
from .registry import register

ARCH = LMArch(
    name="deepseek-coder-33b",
    n_layers=62,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=19200,
    vocab=32256,
    activation="silu",
)

register(ARCH, LM_SHAPES)

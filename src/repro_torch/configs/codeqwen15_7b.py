"""CodeQwen1.5-7B dense LM (hf:Qwen/CodeQwen1.5-7B; hf tier).

32L d_model=4096 32H (GQA kv=32 — effectively MHA, head_dim=128),
d_ff=13440 SwiGLU, vocab=92416.
"""
from .base import LM_SHAPES, LMArch
from .registry import register

ARCH = LMArch(
    name="codeqwen1.5-7b",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    head_dim=128,
    d_ff=13440,
    vocab=92416,
    activation="silu",
)

register(ARCH, LM_SHAPES)

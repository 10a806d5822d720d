"""IBM Granite-3.0 1b-a400m MoE LM (hf:ibm-granite; hf tier).

24L d_model=1024 16H (GQA kv=8, head_dim=64) vocab=49155,
MoE 32 experts top-8, expert d_ff=512.
"""
from .base import LM_SHAPES, LMArch, MoESpec
from .registry import register

ARCH = LMArch(
    name="granite-moe-1b-a400m",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab=49155,
    activation="silu",
    moe=MoESpec(num_experts=32, top_k=8, d_ff=512, capacity_factor=1.25),
)

register(ARCH, LM_SHAPES)

"""Llama-4 Maverick-class MoE LM (hf:meta-llama; unverified tier).

48L d_model=5120 40H (GQA kv=8, head_dim=128) vocab=202048,
MoE 128 experts top-1 with expert d_ff=8192.  Early-fusion multimodality
is out of scope for the LM backbone cells (text tokens only).
Adafactor is mandatory at this scale (DESIGN.md §6 memory plan).
"""
from .base import LM_SHAPES, LMArch, MoESpec
from .registry import register

ARCH = LMArch(
    name="llama4-maverick-400b-a17b",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=202048,
    activation="silu",
    moe=MoESpec(num_experts=128, top_k=1, d_ff=8192, capacity_factor=1.25),
    optimizer="adafactor",
)

register(ARCH, LM_SHAPES)

"""DLRM RM2 (Naumov et al., arXiv:1906.00091), as the JAX package
publishes it.

13 dense + 26 sparse features, embed_dim 64, bottom MLP 13-512-256-64,
top MLP 415-512-256-1 (its input is the 351 pairwise dots of the 27
feature vectors plus the bottom output), dot interaction, 10 485 760 rows
per table, one id per bag.  The tables alone are 26 × 10 485 760 × 64
f32 = 65.0 GiB.
"""
from .base import DLRM_SHAPES, DLRMArch
from .registry import register

ARCH = DLRMArch(
    name="dlrm-rm2",
    n_dense=13,
    n_sparse=26,
    embed_dim=64,
    bot_mlp=(512, 256, 64),
    top_mlp=(512, 256, 1),
    interaction="dot",
    rows_per_table=10_485_760,  # 10x2^20
    hot_size=1,
)

register(ARCH, DLRM_SHAPES)

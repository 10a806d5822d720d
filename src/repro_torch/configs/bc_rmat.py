"""The paper's own workload: MGBC on R-MAT graphs (paper §4.1/4.3), as the
JAX package publishes it.

SCALE 23/25, EF 16 — the strong-scaling configurations of Figs. 4-6.
The cell (``launch/steps.py:build_cell``) runs one BC round (forward
counting + dependency accumulation, 2-D partitioned) with a static level
bound of ``max_levels``.
"""
from .base import BC_SHAPES, BCArch
from .registry import register

ARCH = BCArch(
    name="bc-rmat",
    scale=23,
    edge_factor=16,
    batch_size=16,
    heuristics="h3",
    max_levels=12,  # R-MAT EF16 diameter ~6-8 (paper Table 1)
)

register(ARCH, BC_SHAPES)

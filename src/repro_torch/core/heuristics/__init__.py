"""Topology heuristics (paper §3.4): 1-degree reduction, 2-degree DMF.

  h0    no preprocessing — every eligible vertex runs a forward BFS.
  h1    1-degree reduction (one_degree.py).
  h2    2-degree Dynamic Merging of Frontiers (two_degree.py).
  h3    h1 + h2 (h2 claims 2-degree vertices of the h1 residual graph).
  h1t / h3t   the 1-degree pass repeats to a fixed point, contracting
        whole pendant trees.
"""
from .one_degree import OneDegreeReduction, leaf_correction, one_degree_reduce
from .two_degree import claim_two_degree, derive_two_degree_columns

__all__ = [
    "OneDegreeReduction",
    "one_degree_reduce",
    "leaf_correction",
    "claim_two_degree",
    "derive_two_degree_columns",
]

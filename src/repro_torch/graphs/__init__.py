"""Graph substrate: the container, the seeded generators and the 2-D
partition (numpy)."""
from .graph import Graph
from .partition import (
    BlockedSparseLayout,
    HybridLayout,
    TwoDPartition,
    default_tile_dim,
    partition_2d,
    partition_arcs_2d,
)
from .generators import (
    WEIGHT_MODES,
    complete_graph,
    cycle_graph,
    disjoint_union,
    gnp_graph,
    grid_graph,
    path_graph,
    rmat_graph,
    road_like_graph,
    sized_mesh_graph,
    sized_rmat_graph,
    skewed_depth_graph,
    star_graph,
    suburb_graph,
    weighted_copy,
)

__all__ = [
    "Graph",
    "TwoDPartition",
    "BlockedSparseLayout",
    "HybridLayout",
    "default_tile_dim",
    "partition_2d",
    "partition_arcs_2d",
    "rmat_graph",
    "sized_rmat_graph",
    "sized_mesh_graph",
    "path_graph",
    "cycle_graph",
    "star_graph",
    "complete_graph",
    "grid_graph",
    "gnp_graph",
    "disjoint_union",
    "road_like_graph",
    "suburb_graph",
    "skewed_depth_graph",
    "WEIGHT_MODES",
    "weighted_copy",
]

"""Graph substrate: the container and the seeded generators (numpy)."""
from .graph import Graph
from .generators import (
    complete_graph,
    cycle_graph,
    disjoint_union,
    gnp_graph,
    grid_graph,
    path_graph,
    rmat_graph,
    road_like_graph,
    skewed_depth_graph,
    star_graph,
    suburb_graph,
)

__all__ = [
    "Graph",
    "rmat_graph",
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
]

"""The port's 2-D partition (graphs/partition.py) against the JAX package's:
the same graph and grid give the same arrays (exact equality — both sides
are the same numpy arithmetic), and a cell's dense block built on the
device equals the JAX package's host-side ``dense_blocks()[i, j]``."""
import numpy as np
import pytest
import torch

import repro.graphs as jg
from repro.graphs import partition as jpart
import repro_torch.graphs as pg
from repro_torch import interop
from repro_torch.graphs import partition as ppart

# the tests/test_bc_core.py families, as (name, builder(graphs module))
FAMILIES = {
    "path9": lambda m: m.path_graph(9),
    "cycle13": lambda m: m.cycle_graph(13),
    "star7": lambda m: m.star_graph(7),
    "complete6": lambda m: m.complete_graph(6),
    "grid4x5": lambda m: m.grid_graph(4, 5),
    "gnp24_s0": lambda m: m.gnp_graph(24, 0.12, seed=0),
    "rmat6": lambda m: m.rmat_graph(6, 4, seed=3),
    "road4x4": lambda m: m.road_like_graph(4, 4, spur_fraction=0.5, seed=1),
    "multi": lambda m: m.disjoint_union(
        m.path_graph(6), m.star_graph(4), m.cycle_graph(5), m.gnp_graph(12, 0.2, seed=7)
    ),
    "isolated": lambda m: m.disjoint_union(
        m.gnp_graph(10, 0.25, seed=9), m.path_graph(1), m.path_graph(1)
    ),
}
GRIDS = [(2, 4), (4, 2), (3, 3)]  # 3x3: ragged, n rarely a multiple of 9


def _pair(name, R, C):
    return (
        jpart.partition_2d(FAMILIES[name](jg), R, C),
        ppart.partition_2d(FAMILIES[name](pg), R, C),
    )


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_partition_2d_equals_jax(name, grid):
    want, got = _pair(name, *grid)
    assert (got.R, got.C, got.n, got.chunk, got.n_pad) == (
        want.R, want.C, want.n, want.chunk, want.n_pad
    )
    for field in ("src_local", "dst_local", "arc_counts", "arc_perm"):
        w, g = getattr(want, field), getattr(got, field)
        assert g.dtype == w.dtype, field
        np.testing.assert_array_equal(g, w, err_msg=field)
    np.testing.assert_array_equal(got.vertex_chunk_owner(), want.vertex_chunk_owner())
    for i in range(got.R):
        for j in range(got.C):
            assert got.owned_vertex_base(i, j) == want.owned_vertex_base(i, j)


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("name", ["gnp24_s0", "road4x4", "multi", "rmat6"])
def test_cell_dense_block_equals_jax_dense_blocks(name, grid):
    want, got = _pair(name, *grid)
    blocks = want.dense_blocks(np.float32)
    np.testing.assert_array_equal(got.dense_blocks(np.float32), blocks)
    for i in range(got.R):
        for j in range(got.C):
            for dtype in (torch.float32, torch.bfloat16):
                cell = got.cell_dense_block(i, j, dtype, "cpu")
                assert cell.dtype == dtype
                assert cell.shape == (got.C * got.chunk, got.R * got.chunk)
                np.testing.assert_array_equal(cell.float().numpy(), blocks[i, j])


def test_dense_blocks_reassemble_the_adjacency():
    """Block (i, j) is A[rows_i, cols_j] in the collectives' local order."""
    g = pg.gnp_graph(22, 0.2, seed=4)
    part = ppart.partition_2d(g, 2, 4)
    R, C, chunk = part.R, part.C, part.chunk
    A = np.zeros((part.n_pad, part.n_pad), np.float32)
    A[: g.n, : g.n] = g.dense_adjacency(np.float32)
    blocks = part.dense_blocks()
    for i in range(R):
        rows = np.concatenate([np.arange(chunk) + (m * R + i) * chunk for m in range(C)])
        for j in range(C):
            cols = np.arange(R * chunk) + j * R * chunk
            # arc (u, v) lands at [dst row, src col]; A is symmetric
            np.testing.assert_array_equal(blocks[i, j], A[np.ix_(rows, cols)])


def test_partition_arcs_2d_rejects_a_short_max_arcs():
    g = pg.complete_graph(6)
    with pytest.raises(ValueError, match="max_arcs"):
        ppart.partition_arcs_2d(g.src, g.dst, g.n, 2, 2, max_arcs=1)


def test_partition_from_arrays_carries_the_jax_partition():
    want = jpart.partition_2d(FAMILIES["road4x4"](jg), 2, 4)
    got = interop.partition_from_arrays(
        want.R, want.C, want.n, want.chunk, want.src_local, want.dst_local,
        want.arc_counts, want.arc_perm,
    )
    ref = ppart.partition_2d(FAMILIES["road4x4"](pg), 2, 4)
    for field in ("src_local", "dst_local", "arc_counts", "arc_perm"):
        np.testing.assert_array_equal(getattr(got, field), getattr(ref, field))
    with pytest.raises(ValueError):
        interop.partition_from_arrays(2, 4, want.n, 1, want.src_local, want.dst_local,
                                      want.arc_counts)

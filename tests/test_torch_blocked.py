"""The port's blocked-sparse (BCSR) slice against the JAX package's: the
host layouts and counts of graphs/partition.py, the cell list built on
the device, the plain versions of K5/K6 (kernels/ops.py), the byte model
(roofline/model.py), the hybrid cell choice and the memory guard
(core/distributed.py).

Layouts, counts, choices and byte counts are the same numpy arithmetic on
both sides and are held exactly.  K5's partial is an integer-valued sum
and is held exactly against the JAX Pallas kernel in interpret mode; K6's
at rtol 1e-5 / atol 1e-6 (g is fractional and the two sum in different
orders), the JAX kernel tests' own tolerance.  The CUDA kernels are tested
on the card by tests/test_torch_gpu.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.graphs as jg
from repro.core import distributed as jdist
from repro.graphs import partition as jpart
from repro.kernels import ops as jops
from repro.roofline import model as jmodel
import repro_torch.graphs as pg
from repro_torch.core import distributed as pdist
from repro_torch.graphs import partition as ppart
from repro_torch.kernels import ops, ref
from repro_torch.kernels.blocked_spmm import tile_row_ptr
from repro_torch.roofline import model as pmodel

# n = 320, so chunk = 40 on an 8-cell grid: tiles of 4, 5 and 8 all divide it
GRAPHS = {
    "gnp320": lambda m: m.gnp_graph(320, 0.015, seed=0),
    "road16x20": lambda m: m.road_like_graph(16, 20, spur_fraction=0.5, seed=1),
}
GRIDS = [(2, 4), (4, 2)]
TILES = [(8, 8), (4, 8), (5, 5)]
ENGINES = {"sparse": "sparse", "fused": "pallas", "fused_bf16": "pallas_bf16",
           "fused_sparse": "pallas_sparse"}


def _pair(name, R, C):
    return (jpart.partition_2d(GRAPHS[name](jg), R, C),
            ppart.partition_2d(GRAPHS[name](pg), R, C))


def _assert_layout_equal(got, want):
    assert (got.bm, got.bk, got.R, got.C, got.chunk) == (want.bm, want.bk, want.R, want.C,
                                                         want.chunk)
    for field in ("tiles", "tile_rows", "tile_cols", "nnz_tiles"):
        w, g = getattr(want, field), getattr(got, field)
        assert g.dtype == w.dtype, field
        np.testing.assert_array_equal(g, w, err_msg=field)
    assert got.adjacency_bytes() == want.adjacency_bytes()
    assert (got.num_tile_rows, got.num_tile_cols) == (want.num_tile_rows, want.num_tile_cols)


def _assert_counts_equal(got, want):
    assert got.keys() == want.keys()
    for key, w in want.items():
        np.testing.assert_array_equal(got[key], w, err_msg=key)


def _mask(R, C, seed):
    mask = np.random.default_rng(seed).random((R, C)) < 0.5
    mask[0, 0], mask[-1, -1] = True, False  # both kinds of cell
    return mask


@pytest.mark.parametrize("tile", TILES, ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_blocked_sparse_layout_and_counts_equal_jax(name, grid, tile):
    want, got = _pair(name, *grid)
    _assert_layout_equal(got.blocked_sparse(*tile), want.blocked_sparse(*tile))
    _assert_counts_equal(got.blocked_sparse_counts(*tile), want.blocked_sparse_counts(*tile))
    np.testing.assert_array_equal(got.nnz_tile_counts(*tile), want.nnz_tile_counts(*tile))


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_masked_and_hybrid_layouts_equal_jax(name, grid):
    want, got = _pair(name, *grid)
    cells = _mask(*grid, seed=len(name))
    _assert_layout_equal(got.blocked_sparse(4, 8, cells=cells),
                         want.blocked_sparse(4, 8, cells=cells))
    _assert_counts_equal(got.blocked_sparse_counts(4, 8, cells=cells),
                         want.blocked_sparse_counts(4, 8, cells=cells))
    w, g = want.blocked_hybrid(5, 5, dense_cells=cells), got.blocked_hybrid(5, 5, dense_cells=cells)
    np.testing.assert_array_equal(g.dense_cells, w.dense_cells)
    np.testing.assert_array_equal(g.blocks, w.blocks)
    _assert_layout_equal(g.sparse, w.sparse)
    assert g.host_bytes() == w.host_bytes()


def test_default_tile_dim_equals_jax():
    for chunk in (1, 5, 7, 12, 40, 96, 130, 256, 8192, 65536, 262144):
        assert ppart.default_tile_dim(chunk) == jpart.default_tile_dim(chunk)
    _, got = _pair("gnp320", 2, 4)
    with pytest.raises(ValueError, match="divide chunk"):
        got.blocked_sparse(3, 8)


def test_ring_and_weighted_tiles_raise_with_their_item():
    _, got = _pair("gnp320", 2, 4)
    with pytest.raises(NotImplementedError, match="item 7"):
        got.blocked_sparse(8, 8, ring=True)
    with pytest.raises(NotImplementedError, match="item 11"):
        got.blocked_hybrid(8, 8, dense_cells=np.ones((2, 4), bool),
                           weights=np.ones(GRAPHS["gnp320"](pg).src.size, np.float32))


@pytest.mark.parametrize("tile", TILES + [(None, None)], ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_cell_blocked_sparse_is_the_jax_cell_without_its_pad(grid, tile):
    want, got = _pair("road16x20", *grid)
    layout = want.blocked_sparse(*tile)
    stored = want.blocked_sparse_counts(*tile)["stored_full_cell"]
    num_tr = layout.num_tile_rows
    for i in range(got.R):
        for j in range(got.C):
            tiles, rows, cols, row_ptr = got.cell_blocked_sparse(i, j, *tile, device="cpu")
            t = int(stored[i, j])
            assert tiles.dtype == torch.float32 and rows.dtype == cols.dtype == torch.int32
            np.testing.assert_array_equal(tiles.numpy(), layout.tiles[i, j, :t])
            np.testing.assert_array_equal(rows.numpy(), layout.tile_rows[i, j, :t])
            np.testing.assert_array_equal(cols.numpy(), layout.tile_cols[i, j, :t])
            # the JAX cell's remainder is the trailing pad: zero tiles on the last row
            assert not layout.tiles[i, j, t:].any()
            assert (layout.tile_rows[i, j, t:] == num_tr - 1).all()
            np.testing.assert_array_equal(
                row_ptr.numpy(), np.searchsorted(layout.tile_rows[i, j, :t], np.arange(num_tr + 1))
            )
            np.testing.assert_array_equal(row_ptr.numpy(), tile_row_ptr(rows, num_tr).numpy())


def _tile_list(num_tr, num_tc, bm, bk, seed, pad=3):
    """A row-sorted, row-complete random tile list: 0–3 distinct tiles per
    tile-row (an all-zero filler where a row has none) and ``pad`` trailing
    zero tiles on the last row, as the JAX layout pads."""
    rng = np.random.default_rng(seed)
    rows, cols, data = [], [], []
    for r in range(num_tr):
        picks = rng.choice(num_tc, size=min(num_tc, int(rng.integers(0, 4))), replace=False)
        if picks.size == 0:
            rows.append(r), cols.append(0), data.append(np.zeros((bm, bk), np.float32))
        for c in np.sort(picks):
            rows.append(r), cols.append(int(c))
            data.append((rng.random((bm, bk)) < 0.3).astype(np.float32))
    for _ in range(pad):
        rows.append(num_tr - 1), cols.append(0), data.append(np.zeros((bm, bk), np.float32))
    return np.stack(data), np.array(rows, np.int32), np.array(cols, np.int32)


def _state(k, s, seed, lvl=2):
    """A plausible mid-traversal state (as tests/test_kernels.py builds it)."""
    rng = np.random.default_rng(seed)
    sigma = rng.integers(0, 5, size=(k, s)).astype(np.float32)
    depth = rng.integers(-1, lvl + 3, size=(k, s)).astype(np.int32)
    sigma = np.where(depth >= 0, np.maximum(sigma, 1.0), 0.0).astype(np.float32)
    delta = (rng.random((k, s)).astype(np.float32) * (depth >= 0)).astype(np.float32)
    omega = rng.integers(0, 3, size=k).astype(np.float32)
    return sigma, depth, delta, omega


# (num_tile_rows, num_tile_cols, bm, bk, s): bm != bk, fillers, ragged s
SPARSE_SHAPES = [(6, 5, 5, 8, 33), (4, 7, 8, 5, 130), (9, 3, 4, 4, 4)]


@pytest.mark.parametrize("shape", SPARSE_SHAPES, ids=lambda x: "-".join(map(str, x)))
def test_sparse_partials_match_jax_kernels(shape):
    num_tr, num_tc, bm, bk, s = shape
    m, kdim = num_tr * bm, num_tc * bk
    tiles, rows, cols = _tile_list(num_tr, num_tc, bm, bk, seed=sum(shape))
    sigma, depth, delta, omega = _state(kdim, s, seed=m + s)
    acc = np.random.default_rng(s).integers(0, 7, size=(m, s)).astype(np.float32)
    J = lambda *xs: tuple(jnp.asarray(x) for x in xs)  # noqa: E731
    T = lambda *xs: tuple(torch.from_numpy(x) for x in xs)  # noqa: E731
    for t_in in (None, acc):
        jacc = None if t_in is None else jnp.asarray(t_in)
        tacc = None if t_in is None else torch.from_numpy(t_in)
        want5 = jops.frontier_spmm_sparse(*J(tiles, rows, cols, sigma, depth), 2, m=m, acc=jacc,
                                          use_pallas=True, interpret=True)
        got5 = ops.frontier_spmm_sparse(*T(tiles, rows, cols, sigma, depth), 2, m=m, acc=tacc)
        np.testing.assert_array_equal(got5.numpy(), np.asarray(want5))
        want6 = jops.dependency_spmm_sparse(*J(tiles, rows, cols, sigma, depth, delta, omega), 1,
                                            m=m, acc=jacc, use_pallas=True, interpret=True)
        row_ptr = tile_row_ptr(torch.from_numpy(rows), num_tr)
        got6 = ops.dependency_spmm_sparse(*T(tiles, rows, cols, sigma, depth, delta, omega), 1,
                                          m=m, acc=tacc, row_ptr=row_ptr)
        np.testing.assert_allclose(got6.numpy(), np.asarray(want6), rtol=1e-5, atol=1e-6)
        assert got5.shape == got6.shape == (m, s)


def test_sparse_partials_on_a_partition_cell_equal_the_dense_partials():
    """K5/K6's plain versions on a real cell list equal K3/K4's on the
    cell's dense block (the BCSR engine computes the dense engine's t)."""
    _, part = _pair("road16x20", 2, 4)
    sigma, depth, delta, omega = (torch.from_numpy(x) for x in _state(part.R * part.chunk, 8, 3))
    m = part.C * part.chunk
    for i, j in ((0, 0), (1, 3)):
        tiles, rows, cols, row_ptr = part.cell_blocked_sparse(i, j, 5, 8, device="cpu")
        block = part.cell_dense_block(i, j, device="cpu")
        torch.testing.assert_close(ref.tiles_to_dense(tiles, rows, cols, m, block.shape[1]),
                                   block, rtol=0, atol=0)
        assert torch.equal(
            ops.frontier_spmm_sparse(tiles, rows, cols, sigma, depth, 2, m=m, row_ptr=row_ptr),
            ops.frontier_spmm_partial(block, sigma, depth, 2),
        )
        torch.testing.assert_close(
            ops.dependency_spmm_sparse(tiles, rows, cols, sigma, depth, delta, omega, 1, m=m),
            ops.dependency_spmm_partial(block, sigma, depth, delta, omega, 1),
            rtol=1e-5, atol=1e-6,
        )


def test_sparse_wrappers_reject_bad_operands():
    tiles, rows, cols = _tile_list(4, 3, 4, 4, seed=0)
    sigma, depth, delta, omega = (torch.from_numpy(x) for x in _state(12, 4, 0))
    tiles, rows, cols = (torch.from_numpy(x) for x in (tiles, rows, cols))
    good = (tiles, rows, cols, sigma, depth)
    ops.frontier_spmm_sparse(*good, 2, m=16)  # fine
    bad_calls = [
        lambda: ops.frontier_spmm_sparse(tiles.double(), *good[1:], 2, m=16),
        lambda: ops.frontier_spmm_sparse(tiles[0], *good[1:], 2, m=16),
        lambda: ops.frontier_spmm_sparse(tiles, rows.long(), *good[2:], 2, m=16),
        lambda: ops.frontier_spmm_sparse(tiles, rows[:-1], *good[2:], 2, m=16),
        lambda: ops.frontier_spmm_sparse(*good, 2, m=18),  # m not a multiple of bm
        lambda: ops.frontier_spmm_sparse(*good[:3], sigma[:10], depth[:10], 2, m=16),
        lambda: ops.frontier_spmm_sparse(*good, 2, m=16, row_ptr=torch.zeros(4, dtype=torch.int32)),
        lambda: ops.frontier_spmm_sparse(*good, 2, m=16, acc=torch.zeros(16, 5)),
        lambda: ops.dependency_spmm_sparse(*good, delta, omega[:5], 1, m=16),
        lambda: ops.dependency_spmm_sparse(*good, delta.int(), omega, 1, m=16),
    ]
    for call in bad_calls:
        with pytest.raises((TypeError, ValueError)):
            call()


# ------------------------------------------------------------ byte model


def test_cell_kernel_choice_equals_jax():
    rng = np.random.default_rng(0)
    for R, C, chunk, bm, bk in ((2, 4, 40, 8, 8), (4, 2, 40, 5, 5), (1, 1, 65536, 128, 128)):
        stored = rng.integers(0, 4 * chunk * chunk // (bm * bk), size=(R, C))
        for threshold in (0.0, 0.25, 1.0, 3.0, 1e9):
            kw = dict(R=R, C=C, chunk=chunk, bm=bm, bk=bk, threshold=threshold)
            np.testing.assert_array_equal(pmodel.cell_kernel_choice(stored, **kw),
                                          jmodel.cell_kernel_choice(stored, **kw))
    assert pmodel.TILE_OVERHEAD_BYTES == jmodel.TILE_OVERHEAD_BYTES
    assert pmodel.sparse_tile_bytes(128, 32) == jmodel.sparse_tile_bytes(128, 32)


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_byte_model_equals_jax(engine):
    jengine = ENGINES[engine]
    assert pmodel.exchange_operands(engine) == jmodel.exchange_operands(jengine)
    for R, C, chunk, s in ((2, 4, 40, 16), (1, 1, 65536, 128), (4, 2, 4096, 192)):
        kw = dict(R=R, C=C, chunk=chunk, nnz_tiles=1234, bm=32, bk=16, max_arcs=5000)
        assert pmodel.adjacency_stream_bytes(engine, **kw) == jmodel.adjacency_stream_bytes(
            jengine, **kw)
        got = pmodel.device_hbm_footprint(engine, batch_size=s, **kw)
        want = jmodel.device_hbm_footprint(jengine, batch_size=s, **kw)
        assert got == dict(want, engine_kind=engine)


@pytest.mark.parametrize("engine", sorted(ENGINES))
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_estimate_device_footprint_equals_jax(engine, grid):
    want_part, got_part = _pair("gnp320", *grid)
    got = pdist.estimate_device_footprint(got_part, engine, 16, bm=8, bk=8)
    want = jdist.estimate_device_footprint(want_part, ENGINES[engine], 16, bm=8, bk=8)
    assert got == dict(want, engine_kind=engine)


@pytest.mark.parametrize("threshold", [0.0, 0.5, 1.0, 1e9])
def test_hybrid_cell_choice_equals_jax(threshold):
    """rmat_graph(8, 8, seed=0) on 2x4 at tile 8 mixes dense and BCSR cells
    at the break-even (tests/test_hybrid.py's skewed case)."""
    want_part = jpart.partition_2d(jg.rmat_graph(8, 8, seed=0), 2, 4)
    got_part = ppart.partition_2d(pg.rmat_graph(8, 8, seed=0), 2, 4)
    got, got_counts = pdist.hybrid_cell_choice(got_part, 8, 8, threshold=threshold)
    want, want_counts = jdist.hybrid_cell_choice(want_part, 8, 8, threshold=threshold)
    np.testing.assert_array_equal(got, want)
    _assert_counts_equal(got_counts, want_counts)
    if threshold == 1.0:
        assert 0 < int(got.sum()) < got.size
    if threshold == 0.0:
        assert got.all()


def test_hybrid_footprint_prices_each_ranks_choice_only():
    """The port's fused_hybrid rank holds its chosen representation only:
    the largest rank decides, which is at most the JAX union footprint."""
    part = ppart.partition_2d(pg.rmat_graph(8, 8, seed=0), 2, 4)
    dense_cells, counts = pdist.hybrid_cell_choice(part, 8, 8)
    foot = pdist.estimate_device_footprint(part, "fused_hybrid", 16, bm=8, bk=8,
                                           dense_cells=dense_cells)
    dense = pdist.estimate_device_footprint(part, "fused", 16)
    assert foot["adjacency_bytes"] == dense["adjacency_bytes"]  # a dense-chosen cell exists
    stored = counts["stored_full_cell"]
    all_sparse = pdist.estimate_device_footprint(
        part, "fused_hybrid", 16, bm=8, bk=8, dense_cells=np.zeros((2, 4), bool))
    assert all_sparse["adjacency_bytes"] == stored.max() * pmodel.sparse_tile_bytes(8, 8)
    want_part = jpart.partition_2d(jg.rmat_graph(8, 8, seed=0), 2, 4)
    union = jdist.estimate_device_footprint(want_part, "pallas_hybrid", 16, bm=8, bk=8,
                                            dense_cells=dense_cells)
    assert foot["total_bytes"] < union["total_bytes"]


def test_footprint_sparse_below_dense_and_guard_fires():
    """tests/test_blocked_spmm.py's guard case on the port's engines."""
    part = ppart.partition_2d(pg.rmat_graph(10, 4, seed=1), 2, 4)
    dense = pdist.estimate_device_footprint(part, "fused", 16)
    sparse = pdist.estimate_device_footprint(part, "fused_sparse", 16, bm=8, bk=8)
    assert sparse["adjacency_bytes"] < dense["adjacency_bytes"]
    budget = (dense["total_bytes"] + sparse["total_bytes"]) / 2
    for engine in ("fused", "fused_bf16", "fused_hybrid"):
        cells = np.ones((2, 4), bool) if engine == "fused_hybrid" else None
        if engine == "fused_bf16" and pdist.estimate_device_footprint(
                part, engine, 16)["total_bytes"] <= budget:
            continue
        with pytest.raises(MemoryError, match="fused_sparse"):
            pdist.check_device_memory(part, engine, 16, budget, bm=8, bk=8, dense_cells=cells)
    assert pdist.check_device_memory(part, "fused_sparse", 16, budget, bm=8, bk=8) == sparse
    pdist.check_device_memory(part, "fused", 16, None)  # guard disarmed
    with pytest.raises(MemoryError, match="larger grid"):
        pdist.check_device_memory(part, "fused_sparse", 16, 1.0, bm=8, bk=8)

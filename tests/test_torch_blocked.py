"""The port's blocked-sparse (BCSR) slice against the JAX package's: the
host layouts and counts of graphs/partition.py, the cell list built on
the device, the nonzero index that K5/K6 read on the card
(kernels/blocked_spmm.py:nonzero_index), the plain versions of K5/K6
(kernels/ops.py, kernels/ref.py), the byte model (roofline/model.py), the
hybrid cell choice and the memory guard (core/distributed.py).

Layouts, counts, choices, indexes and byte counts are the same numpy
arithmetic on both sides and are held exactly.  K5's partial is an
integer-valued sum and is held exactly against the JAX Pallas kernel in
interpret mode; K6's at rtol 1e-5 / atol 1e-6 (g is fractional and the two
sum in different orders), the JAX kernel tests' own tolerance.  The CUDA
kernels are tested on the card by tests/test_torch_gpu.py; here their
schedule over the index (segments, then long rows combined) is replayed
on the host.
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
from repro_torch.kernels.blocked_spmm import SEGMENT, nonzero_index
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
    """The ring-sliced layout is ported (bit-equal to the JAX package's:
    tests/test_torch_ring_host.py); a weighted ring layout raises
    ``ValueError`` as the JAX package's does (weighted rounds run the
    barrier schedule); weighted tiles themselves are ported
    (tests/test_torch_weighted.py)."""
    want, got = _pair("gnp320", 2, 4)
    ring = got.blocked_sparse(8, 8, ring=True)
    assert ring.tiles is None and ring.ring_tiles.shape[:3] == (2, 4, 2)
    np.testing.assert_array_equal(ring.ring_tiles, want.blocked_sparse(8, 8, ring=True).ring_tiles)
    w = np.ones(GRAPHS["gnp320"](pg).src.size, np.float32)
    for part in (got, want):
        with pytest.raises(ValueError, match="barrier-schedule only"):
            part.blocked_hybrid(8, 8, dense_cells=np.ones((2, 4), bool), ring=True, weights=w)


@pytest.mark.parametrize("tile", TILES + [(None, None)], ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_cell_blocked_sparse_is_the_jax_cell_without_its_pad(grid, tile):
    want, got = _pair("road16x20", *grid)
    layout = want.blocked_sparse(*tile)
    stored = want.blocked_sparse_counts(*tile)["stored_full_cell"]
    num_tr = layout.num_tile_rows
    for i in range(got.R):
        for j in range(got.C):
            tiles, rows, cols = got.cell_blocked_sparse(i, j, *tile, device="cpu")
            t = int(stored[i, j])
            assert tiles.dtype == torch.float32 and rows.dtype == cols.dtype == torch.int32
            np.testing.assert_array_equal(tiles.numpy(), layout.tiles[i, j, :t])
            np.testing.assert_array_equal(rows.numpy(), layout.tile_rows[i, j, :t])
            np.testing.assert_array_equal(cols.numpy(), layout.tile_cols[i, j, :t])
            # the JAX cell's remainder is the trailing pad: zero tiles on the last row
            assert not layout.tiles[i, j, t:].any()
            assert (layout.tile_rows[i, j, t:] == num_tr - 1).all()


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
        got6 = ops.dependency_spmm_sparse(*T(tiles, rows, cols, sigma, depth, delta, omega), 1,
                                          m=m, acc=tacc)
        np.testing.assert_allclose(got6.numpy(), np.asarray(want6), rtol=1e-5, atol=1e-6)
        assert got5.shape == got6.shape == (m, s)


def test_sparse_partials_on_a_partition_cell_equal_the_dense_partials():
    """K5/K6's plain versions on a real cell list equal K3/K4's on the
    cell's dense block (the BCSR engine computes the dense engine's t)."""
    _, part = _pair("road16x20", 2, 4)
    sigma, depth, delta, omega = (torch.from_numpy(x) for x in _state(part.R * part.chunk, 8, 3))
    m = part.C * part.chunk
    for i, j in ((0, 0), (1, 3)):
        tiles, rows, cols = part.cell_blocked_sparse(i, j, 5, 8, device="cpu")
        block = part.cell_dense_block(i, j, device="cpu")
        torch.testing.assert_close(ref.tiles_to_dense(tiles, rows, cols, m, block.shape[1]),
                                   block, rtol=0, atol=0)
        assert torch.equal(
            ops.frontier_spmm_sparse(tiles, rows, cols, sigma, depth, 2, m=m),
            ops.frontier_spmm_partial(block, sigma, depth, 2),
        )
        torch.testing.assert_close(
            ops.dependency_spmm_sparse(tiles, rows, cols, sigma, depth, delta, omega, 1, m=m),
            ops.dependency_spmm_partial(block, sigma, depth, delta, omega, 1),
            rtol=1e-5, atol=1e-6,
        )


def _good_operands():
    """(tiles, rows, cols, σ, d, δ, ω, index) a K5/K6 wrapper takes (m = 16)."""
    tiles, rows, cols = (torch.from_numpy(x) for x in _tile_list(4, 3, 4, 4, seed=0))
    sigma, depth, delta, omega = (torch.from_numpy(x) for x in _state(12, 4, 0))
    return tiles, rows, cols, sigma, depth, delta, omega, nonzero_index(tiles, rows, cols, 16)


K5, K6 = ops.frontier_spmm_sparse, ops.dependency_spmm_sparse
BAD_SPARSE_CALLS = {
    "tiles-f64": lambda t, r, c, sg, d, dl, om, ix: K5(t.double(), r, c, sg, d, 2, m=16),
    "tiles-2d": lambda t, r, c, sg, d, dl, om, ix: K5(t[0], r, c, sg, d, 2, m=16),
    "tile-rows-i64": lambda t, r, c, sg, d, dl, om, ix: K5(t, r.long(), c, sg, d, 2, m=16),
    "tile-rows-short": lambda t, r, c, sg, d, dl, om, ix: K5(t, r[:-1], c, sg, d, 2, m=16),
    "m-not-a-multiple": lambda t, r, c, sg, d, dl, om, ix: K5(t, r, c, sg, d, 2, m=18),
    "k-not-a-multiple": lambda t, r, c, sg, d, dl, om, ix: K5(t, r, c, sg[:10], d[:10], 2, m=16),
    "acc-shape": lambda t, r, c, sg, d, dl, om, ix: K5(t, r, c, sg, d, 2, m=16,
                                                       acc=torch.zeros(16, 5)),
    "omega-length": lambda t, r, c, sg, d, dl, om, ix: K6(t, r, c, sg, d, dl, om[:5], 1, m=16),
    "delta-i32": lambda t, r, c, sg, d, dl, om, ix: K6(t, r, c, sg, d, dl.int(), om, 1, m=16),
    "index-a-tuple": lambda t, r, c, sg, d, dl, om, ix: K5(t, r, c, sg, d, 2, m=16,
                                                           index=tuple(ix)),
    "index-ptr-i64": lambda t, r, c, sg, d, dl, om, ix: K5(
        t, r, c, sg, d, 2, m=16, index=ix._replace(ptr=ix.ptr.long())),
    "index-ptr-length": lambda t, r, c, sg, d, dl, om, ix: K5(
        t, r, c, sg, d, 2, m=16, index=ix._replace(ptr=ix.ptr[:-1])),
    "index-col-i64": lambda t, r, c, sg, d, dl, om, ix: K5(
        t, r, c, sg, d, 2, m=16, index=ix._replace(col=ix.col.long())),
    "index-val-f64": lambda t, r, c, sg, d, dl, om, ix: K6(
        t, r, c, sg, d, dl, om, 1, m=16, index=ix._replace(val=ix.val.double())),
    "index-val-length": lambda t, r, c, sg, d, dl, om, ix: K6(
        t, r, c, sg, d, dl, om, 1, m=16, index=ix._replace(val=ix.val[:-1])),
    "index-seg-width": lambda t, r, c, sg, d, dl, om, ix: K5(
        t, r, c, sg, d, 2, m=16, index=ix._replace(seg=ix.seg[:, :2].contiguous())),
    "index-seg-missing-a-row": lambda t, r, c, sg, d, dl, om, ix: K5(
        t, r, c, sg, d, 2, m=16, index=ix._replace(seg=ix.seg[:-1])),
    "index-long-ptr-empty": lambda t, r, c, sg, d, dl, om, ix: K6(
        t, r, c, sg, d, dl, om, 1, m=16, index=ix._replace(long_ptr=ix.long_ptr[:0])),
    "index-long-ptr-i64": lambda t, r, c, sg, d, dl, om, ix: K6(
        t, r, c, sg, d, dl, om, 1, m=16, index=ix._replace(long_ptr=ix.long_ptr.long())),
    # an index the kernel would read in place of other or changed tiles
    "index-of-other-tiles": lambda t, r, c, sg, d, dl, om, ix: K5(
        t.clone(), r, c, sg, d, 2, m=16, index=ix),
    "index-of-other-tile-cols": lambda t, r, c, sg, d, dl, om, ix: K6(
        t, r, c.flip(0).contiguous(), sg, d, dl, om, 1, m=16, index=ix),
    "index-of-tiles-changed-since": lambda t, r, c, sg, d, dl, om, ix: K5(
        t.mul_(2), r, c, sg, d, 2, m=16, index=ix),
}


@pytest.mark.parametrize("case", sorted(BAD_SPARSE_CALLS))
def test_sparse_wrappers_reject_bad_operands(case):
    good = _good_operands()
    tiles, rows, cols, sigma, depth, delta, omega, index = good
    K5(tiles, rows, cols, sigma, depth, 2, m=16, index=index)  # fine
    K6(tiles, rows, cols, sigma, depth, delta, omega, 1, m=16, index=index)
    with pytest.raises((TypeError, ValueError)):
        BAD_SPARSE_CALLS[case](*good)


# ------------------------------------------------------- nonzero index


def _numpy_index(tiles, rows, cols, m, kdim):
    """(ptr, col, val) of the block the tiles hold, by numpy: scatter the
    tiles into the dense block, then its nonzeros in row-major order."""
    _, bm, bk = tiles.shape
    dense = np.zeros((m, kdim), np.float32)
    for t, r, c in zip(tiles, rows, cols):
        dense[r * bm : (r + 1) * bm, c * bk : (c + 1) * bk] += t
    nz_row, nz_col = np.nonzero(dense)
    return np.searchsorted(nz_row, np.arange(m + 1)), nz_col, dense[nz_row, nz_col]


def _check_work_list(index):
    """The work list of K5/K6: each row longer than SEGMENT cut into
    consecutive segments of at most SEGMENT entries, in front and in row
    order, then every other row whole, in row order."""
    ptr, seg, long_ptr = index.ptr.numpy(), index.seg.numpy(), index.long_ptr.numpy()
    lens = np.diff(ptr)
    long_rows = np.flatnonzero(lens > SEGMENT)
    assert long_ptr[0] == 0 and np.array_equal(
        np.diff(long_ptr), (lens[long_rows] + SEGMENT - 1) // SEGMENT)
    for i, r in enumerate(long_rows):
        part = seg[long_ptr[i] : long_ptr[i + 1]]
        assert (part[:, 0] == r).all() and (part[:, 2] - part[:, 1] <= SEGMENT).all()
        assert part[0, 1] == ptr[r] and part[-1, 2] == ptr[r + 1]
        assert (part[1:, 1] == part[:-1, 2]).all()
    short = np.flatnonzero(lens <= SEGMENT)
    np.testing.assert_array_equal(seg[long_ptr[-1] :], np.stack(
        [short, ptr[short], ptr[short + 1]], 1))


def _replay_kernel(index, operand, acc=None):
    """The CUDA kernels' schedule over the index, on the host: one partial
    per work segment in entry order, a short row written with acc added,
    the segments of a long row summed in order (output starts as NaN, so a
    row that nobody writes shows)."""
    m, s = index.ptr.numel() - 1, operand.shape[1]
    num_long = index.long_ptr.numel() - 1
    num_long_seg = index.seg.shape[0] - (m - num_long)
    out = torch.full((m, s), float("nan"))
    partials = torch.empty((num_long_seg, s))
    for w, (row, lo, hi) in enumerate(index.seg.tolist()):
        part = torch.zeros(s)
        for e in range(lo, hi):
            part = part + index.val[e] * operand[index.col[e]]
        if w < num_long_seg:
            partials[w] = part
        else:
            out[row] = part if acc is None else acc[row] + part
    for i in range(num_long):
        j0, j1 = index.long_ptr[i].item(), index.long_ptr[i + 1].item()
        total = torch.zeros(s)
        for j in range(j0, j1):
            total = total + partials[j]
        row = index.seg[j0, 0].item()
        out[row] = total if acc is None else acc[row] + total
    return out


@pytest.mark.parametrize("tile", TILES + [(None, None)], ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_nonzero_index_equals_numpy_on_the_jax_layouts(name, grid, tile):
    """nonzero_index of every cell of the JAX layout (trailing pad tiles
    included) and of the port's cell list equals the numpy index of the
    cell's block."""
    want, got = _pair(name, *grid)
    layout = want.blocked_sparse(*tile)
    m, kdim = got.C * got.chunk, got.R * got.chunk
    for i in range(got.R):
        for j in range(got.C):
            jax_cell = (layout.tiles[i, j], layout.tile_rows[i, j], layout.tile_cols[i, j])
            ptr, col, val = _numpy_index(*jax_cell, m, kdim)
            port_cell = got.cell_blocked_sparse(i, j, *tile, device="cpu")
            for cell in (tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in jax_cell),
                         port_cell):
                index = nonzero_index(*cell, m)
                assert [t.dtype for t in index.arrays] == [torch.int32] * 2 + [torch.float32] + [
                    torch.int32] * 2
                np.testing.assert_array_equal(index.ptr.numpy(), ptr)
                np.testing.assert_array_equal(index.col.numpy(), col)
                np.testing.assert_array_equal(index.val.numpy(), val)
                assert index.col.numel() == int(np.count_nonzero(cell[0].numpy()))
                _check_work_list(index)


@pytest.mark.parametrize("chunk_tiles", [1, 2, 7, 10**6])
def test_nonzero_index_is_the_same_in_chunks(chunk_tiles):
    """Read in chunks of fewer tiles than T (down to one), the index is
    the one read in one piece, and holds weighted values."""
    tiles, rows, cols = _tile_list(9, 6, 8, 4, seed=5)
    tiles = tiles * np.random.default_rng(1).normal(size=tiles.shape).astype(np.float32)
    args = tuple(torch.from_numpy(x) for x in (tiles, rows, cols))
    assert args[0].shape[0] > 7
    want = _numpy_index(tiles, rows, cols, 72, 24)
    got = nonzero_index(*args, 72, chunk_tiles=chunk_tiles)
    for g, w in zip(got[:3], want):
        np.testing.assert_array_equal(g.numpy(), w)
    for g, w in zip(got.arrays, nonzero_index(*args, 72).arrays):
        assert torch.equal(g, w)


def _skewed_tile_list(num_tc, bm, bk, seed):
    """Tile-row 0 holds num_tc tiles whose first row is all ones (one row
    of num_tc·bk nonzeros, several segments long) over random entries;
    tile-rows 1 and 2 are random, plus a trailing zero pad tile."""
    rng = np.random.default_rng(seed)
    tiles = (rng.random((num_tc + 3, bm, bk)) < 0.2).astype(np.float32)
    tiles[:num_tc, 0, :] = 1.0
    tiles[-1] = 0.0
    rows = np.array([0] * num_tc + [1, 2, 2], np.int32)
    cols = np.concatenate([np.arange(num_tc), [1, 0, 0]]).astype(np.int32)
    return tiles, rows, cols


# (num_tile_rows, num_tile_cols, bm, bk, s) of _tile_list, and a skewed
# list whose longest row (5·64 = 320 + 20 entries) is cut into segments
INDEX_CASES = {**{"-".join(map(str, x)): x for x in SPARSE_SHAPES}, "skewed": None}


@pytest.mark.parametrize("case", sorted(INDEX_CASES))
def test_index_products_match_tile_products_and_jax_kernels(case):
    """The gather-sum over the index (kernels/ref.py:frontier_index_ref /
    dependency_index_ref) and its replay in the kernels' segment schedule
    equal the tile products (ref.frontier_sparse_ref /
    dependency_sparse_ref) and the JAX Pallas K5/K6 in interpret mode,
    plain and acc: K5 exactly, K6 at rtol 1e-5 / atol 1e-6."""
    if INDEX_CASES[case] is None:
        tiles, rows, cols = _skewed_tile_list(5, 4, 64, seed=3)
        m, kdim, s = 3 * 4, 5 * 64, 6
    else:
        num_tr, num_tc, bm, bk, s = INDEX_CASES[case]
        tiles, rows, cols = _tile_list(num_tr, num_tc, bm, bk, seed=sum(INDEX_CASES[case]))
        m, kdim = num_tr * bm, num_tc * bk
    sigma, depth, delta, omega = _state(kdim, s, seed=m + s)
    acc = np.random.default_rng(s).integers(0, 7, size=(m, s)).astype(np.float32)
    T = lambda *xs: tuple(torch.from_numpy(x) for x in xs)  # noqa: E731
    J = lambda *xs: tuple(jnp.asarray(x) for x in xs)  # noqa: E731
    index = nonzero_index(*T(tiles, rows, cols), m)
    _check_work_list(index)
    if case == "skewed":
        assert index.long_ptr.numel() - 1 == 1 and index.long_ptr[-1] == 2
    g = ref._dependency_operand(*T(sigma, depth, delta, omega), 1)
    for t_in in (None, acc):
        tacc = None if t_in is None else torch.from_numpy(t_in)
        jacc = None if t_in is None else jnp.asarray(t_in)
        got5 = ref.frontier_index_ref(index, *T(sigma, depth), 2, tacc)
        assert torch.equal(got5, ref.frontier_sparse_ref(*T(tiles, rows, cols, sigma, depth), 2,
                                                         m, tacc))
        want5 = jops.frontier_spmm_sparse(*J(tiles, rows, cols, sigma, depth), 2, m=m, acc=jacc,
                                          use_pallas=True, interpret=True)
        np.testing.assert_array_equal(got5.numpy(), np.asarray(want5))
        frontier = torch.from_numpy(np.where(depth == 1, sigma, 0.0).astype(np.float32))
        assert torch.equal(_replay_kernel(index, frontier, tacc), got5)
        got6 = ref.dependency_index_ref(index, *T(sigma, depth, delta, omega), 1, tacc)
        torch.testing.assert_close(
            got6, ref.dependency_sparse_ref(*T(tiles, rows, cols, sigma, depth, delta, omega), 1,
                                            m, tacc), rtol=1e-5, atol=1e-6)
        want6 = jops.dependency_spmm_sparse(*J(tiles, rows, cols, sigma, depth, delta, omega), 1,
                                            m=m, acc=jacc, use_pallas=True, interpret=True)
        np.testing.assert_allclose(got6.numpy(), np.asarray(want6), rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(_replay_kernel(index, g, tacc), got6, rtol=1e-5, atol=1e-6)


def test_index_product_skips_zero_entries_on_a_non_finite_operand():
    """The changed edge case: an infinite operand row gives NaN in the
    rows of a tile over it that have no entry on it (0·inf) in the tile
    product; the gather-sum over the index leaves those rows finite, as
    the arc-list engine does.  The row with an entry on it is inf in
    both."""
    tiles = np.zeros((1, 4, 4), np.float32)
    tiles[0, 1, 2] = 1.0
    tiles[0, 3, 0] = 1.0
    args = tuple(torch.from_numpy(x) for x in (tiles, np.zeros(1, np.int32),
                                               np.zeros(1, np.int32)))
    sigma = torch.ones((4, 3))
    sigma[2, 0] = float("inf")
    depth = torch.ones((4, 3), dtype=torch.int32)
    tile_t = ref.frontier_sparse_ref(*args, sigma, depth, 2, 4)
    index_t = ref.frontier_index_ref(nonzero_index(*args, 4), sigma, depth, 2)
    assert tile_t[[0, 2, 3], 0].isnan().all() and tile_t[1, 0] == float("inf")
    assert index_t[1, 0] == float("inf") and index_t[3, 0] == 1.0
    assert (index_t[[0, 2], 0] == 0.0).all()
    assert torch.equal(index_t[:, 1:], tile_t[:, 1:])


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

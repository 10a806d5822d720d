"""The ring schedules' host side against the JAX package's, no spawned
grid: the ring layouts (graphs/partition.py), the per-cell forms a rank
holds, the ring footprints, the level-time model and ``overlap="auto"``
(roofline/model.py, core/distributed.py), the policy checks and the
launchers' ``--overlap`` flag.

Layouts, counts, footprints and estimates are the same numpy arithmetic
on both sides and are held exactly.  The level-time model is held under
the same hardware numbers: the test builds a port ``HardwareSpec`` from
the JAX package's TPU spec (the port itself holds only H100 rates).
"""
import types

import numpy as np
import pytest
import torch

import repro.graphs as jg
from repro.core import distributed as jdist
from repro.graphs import partition as jpart
from repro.roofline import model as jmodel
import repro_torch.graphs as pg
from repro_torch.core import distributed as pdist
from repro_torch.core.bc import betweenness_centrality
from repro_torch.core.operators import DistributedOperator, normalize_overlap
from repro_torch.graphs import partition as ppart
from repro_torch.launch import bc as cli
from repro_torch.launch import serve_bc
from repro_torch.roofline import model as pmodel

# tests/test_torch_partition.py's families and tests/test_torch_blocked.py's tiled graphs
FAMILIES = {
    "path9": lambda m: m.path_graph(9),
    "cycle13": lambda m: m.cycle_graph(13),
    "star7": lambda m: m.star_graph(7),
    "grid4x5": lambda m: m.grid_graph(4, 5),
    "gnp24_s0": lambda m: m.gnp_graph(24, 0.12, seed=0),
    "rmat6": lambda m: m.rmat_graph(6, 4, seed=3),
    "road4x4": lambda m: m.road_like_graph(4, 4, spur_fraction=0.5, seed=1),
    "multi": lambda m: m.disjoint_union(
        m.path_graph(6), m.star_graph(4), m.cycle_graph(5), m.gnp_graph(12, 0.2, seed=7)
    ),
}
TILED = {
    "gnp320": lambda m: m.gnp_graph(320, 0.015, seed=0),
    "road16x20": lambda m: m.road_like_graph(16, 20, spur_fraction=0.5, seed=1),
}
GRIDS = [(2, 4), (4, 2), (3, 3)]
TILED_GRIDS = [(2, 4), (4, 2)]  # chunk 40: tiles of 4, 5 and 8 divide it
TILES = [(8, 8), (4, 8), (5, 5)]
ENGINES = {"sparse": "sparse", "fused": "pallas", "fused_bf16": "pallas_bf16",
           "fused_sparse": "pallas_sparse"}
RINGS = ["expand", "expand+fold"]
gid = lambda g: f"{g[0]}x{g[1]}"  # noqa: E731


def _pair(builders, name, R, C):
    return (jpart.partition_2d(builders[name](jg), R, C),
            ppart.partition_2d(builders[name](pg), R, C))


# ------------------------------------------------------------ layouts
@pytest.mark.parametrize("grid", GRIDS, ids=gid)
@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_ring_arcs_equal_jax(name, grid):
    want, got = _pair(FAMILIES, name, *grid)
    for g, w in zip(got.ring_arcs(), want.ring_arcs()):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got.ring_arcs_max() == want.ring_arcs_max()
    ring_src, ring_dst = want.ring_arcs()
    for i in range(grid[0]):
        for j in range(grid[1]):
            src, dst = got.cell_ring_arcs(i, j)
            assert src.dtype == dst.dtype == torch.int64
            np.testing.assert_array_equal(src.numpy(), ring_src[i, j])
            np.testing.assert_array_equal(dst.numpy(), ring_dst[i, j])


def _assert_ring_layout_equal(got, want):
    assert got.tiles is None and want.tiles is None
    for field in ("ring_tiles", "ring_tile_rows", "ring_tile_cols", "nnz_tiles"):
        w, g = getattr(want, field), getattr(got, field)
        assert g.dtype == w.dtype, field
        np.testing.assert_array_equal(g, w, err_msg=field)
    assert got.adjacency_bytes() == want.adjacency_bytes()


@pytest.mark.parametrize("tile", TILES, ids=gid)
@pytest.mark.parametrize("grid", TILED_GRIDS, ids=gid)
@pytest.mark.parametrize("name", sorted(TILED))
def test_ring_tile_layouts_equal_jax(name, grid, tile):
    want, got = _pair(TILED, name, *grid)
    ring = want.blocked_sparse(*tile, ring=True)
    _assert_ring_layout_equal(got.blocked_sparse(*tile, ring=True), ring)
    dense_cells = np.zeros(grid, bool)
    dense_cells.flat[::3] = True
    g = got.blocked_hybrid(*tile, dense_cells=dense_cells, ring=True)
    w = want.blocked_hybrid(*tile, dense_cells=dense_cells, ring=True)
    np.testing.assert_array_equal(g.blocks, w.blocks)
    _assert_ring_layout_equal(g.sparse, w.sparse)
    # the footprint's ring count is the layout's: R slots of the fullest slot's T
    assert got.blocked_sparse_counts(*tile)["stored_tiles_ring"] == (
        grid[0] * ring.ring_tiles.shape[3])


@pytest.mark.parametrize("tile", TILES, ids=gid)
@pytest.mark.parametrize("grid", TILED_GRIDS, ids=gid)
def test_cell_ring_slots_are_the_jax_slots_without_their_pad(grid, tile):
    """Each rank's R slots, built on its device, are the JAX ring layout's
    slots (i, j, r) cut before their padding, which holds no entry."""
    want, got = _pair(TILED, "gnp320", *grid)
    lay = want.blocked_sparse(*tile, ring=True)
    for i in range(grid[0]):
        for j in range(grid[1]):
            slots = got.cell_ring_blocked_sparse(i, j, *tile)
            assert len(slots) == grid[0]
            for r, (tiles, rows, cols) in enumerate(slots):
                T = tiles.shape[0]
                assert rows.dtype == cols.dtype == torch.int32 and T >= lay.num_tile_rows
                np.testing.assert_array_equal(tiles.numpy(), lay.ring_tiles[i, j, r, :T])
                np.testing.assert_array_equal(rows.numpy(), lay.ring_tile_rows[i, j, r, :T])
                np.testing.assert_array_equal(cols.numpy(), lay.ring_tile_cols[i, j, r, :T])
                assert not lay.ring_tiles[i, j, r, T:].any()
                assert cols.max() < got.chunk // tile[1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("grid", GRIDS, ids=gid)
def test_cell_dense_slabs_are_the_block_column_slices(grid, dtype):
    want, got = _pair(FAMILIES, "gnp24_s0", *grid)
    blocks, chunk = want.dense_blocks(np.float32), got.chunk
    for i in range(grid[0]):
        for j in range(grid[1]):
            slabs = got.cell_dense_slabs(i, j, dtype)
            assert slabs.dtype == dtype and slabs.is_contiguous()
            assert tuple(slabs.shape) == (grid[0], grid[1] * chunk, chunk)
            for r in range(grid[0]):
                np.testing.assert_array_equal(
                    slabs[r].float().numpy(), blocks[i, j][:, r * chunk:(r + 1) * chunk])


def test_weighted_ring_layouts_raise_as_in_jax():
    want, got = _pair(TILED, "gnp320", 2, 4)
    w = np.ones(TILED["gnp320"](pg).src.size, np.float32)
    for part in (got, want):
        with pytest.raises(ValueError, match="barrier-schedule only"):
            part.blocked_sparse(8, 8, ring=True, weights=w)
    with pytest.raises(ValueError, match="barrier-schedule only"):
        got.blocked_hybrid(8, 8, dense_cells=np.ones((2, 4), bool), ring=True, weights=w)


def test_distributed_graph_arrays_ring_forms():
    """What a rank holds under a ring, per engine: the arc slots, the
    column slabs (bf16 for fused_bf16), the tile slots (no index on the
    CPU); weighted operands stay in the barrier form."""
    part = ppart.partition_2d(TILED["gnp320"](pg), 2, 4)
    kw = dict(overlap="expand")
    src, dst = pdist.distributed_graph_arrays(part, "sparse", 1, 2, "cpu", **kw)
    assert tuple(src.shape) == (2, part.ring_arcs_max())
    (slabs,) = pdist.distributed_graph_arrays(part, "fused_bf16", 1, 2, "cpu", **kw)
    assert slabs.dtype == torch.bfloat16 and tuple(slabs.shape) == (2, 4 * 40, 40)
    tiles, rows, cols, index = pdist.distributed_graph_arrays(part, "fused_sparse", 1, 2,
                                                              "cpu", tile=(8, 8), **kw)
    assert len(tiles) == len(rows) == len(cols) == len(index) == 2
    assert index == (None, None)
    w = np.ones(TILED["gnp320"](pg).src.size, np.float32)
    (block,) = pdist.distributed_graph_arrays(part, "fused", 1, 2, "cpu", weights=w, **kw)
    assert tuple(block.shape) == (4 * 40, 2 * 40)


# --------------------------------------------------------- footprints
@pytest.mark.parametrize("overlap", RINGS)
@pytest.mark.parametrize("grid", TILED_GRIDS, ids=gid)
@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_ring_footprint_equals_jax(engine, grid, overlap):
    want_part, got_part = _pair(TILED, "gnp320", *grid)
    got = pdist.estimate_device_footprint(got_part, engine, 16, bm=8, bk=8, overlap=overlap)
    want = jdist.estimate_device_footprint(want_part, ENGINES[engine], 16, bm=8, bk=8,
                                           overlap=overlap)
    assert got == dict(want, engine_kind=engine)
    guard = pdist.check_device_memory(got_part, engine, 16, None, bm=8, bk=8, overlap=overlap)
    assert guard == got


def test_hybrid_ring_footprint_prices_each_ranks_choice_only():
    """Under a ring a sparse-chosen rank holds its R slots (priced at its
    fullest slot), a dense-chosen one the block's bytes; the largest rank
    decides, at most the JAX union footprint."""
    part = ppart.partition_2d(pg.rmat_graph(8, 8, seed=0), 2, 4)
    dense_cells, counts = pdist.hybrid_cell_choice(part, 8, 8)
    kw = dict(bm=8, bk=8, overlap="expand+fold")
    all_sparse = pdist.estimate_device_footprint(
        part, "fused_hybrid", 16, dense_cells=np.zeros((2, 4), bool), **kw)
    assert all_sparse["adjacency_bytes"] == (
        2 * counts["stored_ring_slot_cell"].max() * pmodel.sparse_tile_bytes(8, 8))
    foot = pdist.estimate_device_footprint(part, "fused_hybrid", 16, dense_cells=dense_cells,
                                           **kw)
    union = jdist.estimate_device_footprint(
        jpart.partition_2d(jg.rmat_graph(8, 8, seed=0), 2, 4), "pallas_hybrid", 16,
        dense_cells=dense_cells, **kw)
    assert foot["total_bytes"] < union["total_bytes"]


# ------------------------------------------- level times and "auto"
def _port_hw(spec) -> pmodel.HardwareSpec:
    """A port HardwareSpec holding the JAX spec's numbers (test-side only)."""
    return pmodel.HardwareSpec(name=spec.name, peak_flops=spec.peak_bf16_flops,
                               hbm_bandwidth=spec.hbm_bandwidth,
                               link_bandwidth=spec.ici_link_bandwidth,
                               hop_latency_s=spec.ici_step_latency_s)


@pytest.mark.parametrize("grid", TILED_GRIDS, ids=gid)
@pytest.mark.parametrize("engine", sorted(ENGINES) + ["fused_hybrid"])
def test_level_time_estimates_and_auto_equal_jax(engine, grid):
    want_part, got_part = _pair(TILED, "gnp320", *grid)
    jengine = ENGINES.get(engine, "pallas_hybrid")
    kw = dict(bm=8, bk=8)
    if engine == "fused_hybrid":
        kw["dense_cells"] = pdist.hybrid_cell_choice(got_part, 8, 8)[0]
    for s in (8, 128):
        got = pdist.level_time_estimates(got_part, engine, s, hw=_port_hw(jmodel.V5E), **kw)
        want = jdist.level_time_estimates(want_part, jengine, s, hw=jmodel.V5E, **kw)
        assert got == want
        got_pick = pdist.resolve_overlap("auto", got_part, engine, s, hw=_port_hw(jmodel.V5E),
                                         **kw)
        assert got_pick == jdist.resolve_overlap("auto", want_part, jengine, s, hw=jmodel.V5E,
                                                 **kw)


def test_auto_overlap_policy_and_step_time_equal_jax():
    hw = _port_hw(jmodel.V5E)
    rng = np.random.default_rng(0)
    picks = set()
    for _ in range(200):
        comp, exp, fold = (float(x) for x in 10.0 ** rng.uniform(-7, -3, 3))
        R, C = (int(x) for x in rng.integers(1, 9, 2))
        for k in (1, R):
            assert pmodel.overlap_step_time(comp, exp, k) == jmodel.overlap_step_time(
                comp, exp, k)
        got = pmodel.auto_overlap_policy(comp, exp, fold, R, C, hw=hw)
        assert got == jmodel.auto_overlap_policy(comp, exp, fold, R, C, hw=jmodel.V5E)
        picks.add(got[0])
    assert picks == {"none", "expand", "expand+fold"}
    assert pmodel.H100.peak_flops == 67e12 and pmodel.H100.hbm_bandwidth == 3.35e12


# ------------------------------------------------------ policy checks
def test_overlap_policy_validation():
    with pytest.raises(ValueError, match="unknown overlap policy"):
        normalize_overlap("ring")
    assert normalize_overlap(None) == "none"
    part = ppart.partition_2d(FAMILIES["gnp24_s0"](pg), 2, 4)
    with pytest.raises(ValueError, match="unknown overlap policy"):
        pdist.resolve_overlap("ring", part, "sparse", 8)
    assert pdist.resolve_overlap("expand", part, "sparse", 8) == "expand"
    groups = types.SimpleNamespace(R=2, C=4, fr=1, i=0, j=0)
    with pytest.raises(ValueError, match="barrier-schedule benchmark mode"):
        DistributedOperator(None, None, chunk=3, groups=groups, overlap="expand",
                            split_backward=True)
    with pytest.raises(ValueError, match="sync_axes"):
        DistributedOperator(None, None, chunk=3, groups=groups, sync_axes=("pod",))
    with pytest.raises(ValueError, match="barrier-schedule benchmark mode"):
        pdist.make_distributed_round_fn(part, groups, overlap="expand",
                                        fuse_backward_payload=False)
    with pytest.raises(ValueError, match="fused backward payload"):
        pdist.make_distributed_round_fn(part, groups, integrity="checksum",
                                        fuse_backward_payload=False)
    with pytest.raises(ValueError, match="weighted rounds support integrity='audit'"):
        pdist.make_distributed_round_fn(part, groups, integrity="checksum", delta=0.5)
    with pytest.raises(ValueError, match="distributed-engine feature"):
        betweenness_centrality(FAMILIES["path9"](pg), overlap="expand", device="cpu")


# -------------------------------------------------------------- launchers
@pytest.mark.parametrize("policy", ["none", "expand", "expand+fold", "auto"])
def test_cli_overlap_parses(policy):
    for parser in (cli.build_parser(), serve_bc.build_parser()):
        assert parser.parse_args(["--grid", "3x3", "--overlap", policy]).overlap == policy
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["--grid", "3x3", "--overlap", "ring"])


@pytest.mark.parametrize("main", [cli.main, serve_bc.main], ids=["bc", "serve_bc"])
def test_cli_overlap_needs_a_mesh(main):
    with pytest.raises(SystemExit, match="--overlap is a distributed schedule; pass --mesh"):
        main(["--grid", "3x3", "--overlap", "expand", "--device", "cpu"])


def test_cli_overlap_on_a_gloo_grid(tmp_path, capsys):
    """``--mesh 2x2 --overlap expand+fold --device cpu`` spawns four gloo
    ranks on the ring schedule; rank 0's scores match the oracle."""
    from repro_torch.core import brandes_reference

    out = tmp_path / "bc.npy"
    cli.main(["--grid", "4x5", "--mesh", "2x2", "--engine", "fused", "--heuristics", "h3",
              "--batch-size", "8", "--overlap", "expand+fold", "--device", "cpu",
              "--out", str(out)])
    text = capsys.readouterr().out
    assert "overlap=expand+fold" in text and "collective schedule: overlap=expand+fold" in text
    np.testing.assert_allclose(np.load(out), brandes_reference(pg.grid_graph(4, 5)),
                               rtol=1e-5, atol=1e-5)


# ------------------------------------------------ the audit's level bound
@pytest.mark.parametrize("level_bound", [None, 40])
def test_driver_audit_holds_levels_to_its_level_bound(level_bound):
    """A weighted round reports bucket indices, which may pass n + 1:
    ``BCDriver(level_bound=)`` (the JAX driver's) holds the audit to the
    caller's bound; without it a depth past n + 1 is quarantined."""
    from repro_torch.core.driver import BCDriver, IntegrityError
    from repro_torch.core.scheduler import build_schedule

    graph = FAMILIES["path9"](pg)
    schedule, prep, _, _ = build_schedule(graph, batch_size=4)

    def round_fn(sources, derived):
        fr, s = sources.shape
        cols = s + derived.shape[1]
        roots = torch.cat([sources, derived[:, :, 0]], dim=1)
        bc = torch.zeros((fr, graph.n))
        return (bc, torch.ones((fr, cols)), roots, torch.full((fr,), 30),
                torch.zeros((fr, 2)))

    drv = BCDriver(round_fn, schedule, n=graph.n, device="cpu", prep=prep, integrity="audit",
                   max_retries=0, level_bound=level_bound)
    if level_bound is None:
        with pytest.raises(IntegrityError, match="level bound violation"):
            drv.run()
    else:
        assert drv.run().recovery_stats["quarantined_blocks"] == 0

"""The port's cells (launch/steps.py) against the JAX package's.

The BC configs (``BCArch``, ``BCShape``, ``BC_SHAPES``, ``bc-rmat``) and
the BC cell's ``static_meta`` are held field for field to the JAX
package's, for both shapes on 1x1, 2x4 and 2x2x2 meshes (the JAX cells
on the 8 host devices of tests/conftest.py).  The cell's round runs on a
reduced shape — R-MAT scale 7, EF 16, the arch's batch, h3 and 12 levels
— on spawned gloo 1x1, 2x4 and 2x2x2 grids (tests/torch_cells_worker.py,
one spawn per grid), and every dispatch block is held to the JAX
package's ``make_distributed_round_fn`` round on the same partition and
inputs, at the static bound and with the liveness loop, to the tolerance
tests/test_torch_dist.py holds the grid to (BC rtol 1e-5 / atol 1e-5);
an exact h0 run over every round equals ``brandes_reference``.  The DLRM
dispatch of ``build_cell`` is the DLRM cell.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import repro.configs as jconfigs
from repro.configs import base as jbase
from repro.core.distributed import make_distributed_round_fn as jax_round_fn
from repro.core.scheduler import build_schedule as jax_build_schedule
from repro.graphs import rmat_graph as jax_rmat_graph
from repro.graphs.partition import partition_2d as jax_partition_2d
from repro.launch.mesh import make_mesh
from repro.launch.steps import build_cell as jax_build_cell
import repro_torch.configs as pconfigs
from repro_torch.autotune import CostCache, CostRecord
from repro_torch.core import brandes_reference
from repro_torch.core.distributed import REFERENCE_DIST_ENGINE
from repro_torch.distributed import run_gloo
from repro_torch.graphs import rmat_graph
from repro_torch.launch.steps import BCCell, DLRMCell, build_cell, build_dlrm_cell
import torch_cells_worker

pytestmark = pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 host devices")

MESHES = {"1x1": (1, 1, 1), "2x4": (1, 2, 4), "2x2x2": (2, 2, 2)}
SEED = 3
SMALL = "rmat_s7_ef16"
TOL = dict(rtol=1e-5, atol=1e-5)


def _bundle(cfg=None):
    """bc-rmat with one reduced shape (scale 7, EF 16)."""
    arch = cfg or pconfigs.get_arch("bc-rmat").arch
    return pconfigs.ArchBundle(arch, {SMALL: pconfigs.BCShape(SMALL, 7, 16)})


def _jax_mesh(mesh):
    fr, R, C = MESHES[mesh]
    if fr > 1:
        return make_mesh((fr, R, C), ("pod", "data", "model"))
    return make_mesh((R, C), ("data", "model"))


# ----------------------------------------------------------------- configs
def test_bc_configs_match_jax_field_by_field():
    got, want = pconfigs.get_arch("bc-rmat"), jconfigs.get_arch("bc-rmat")
    assert dataclasses.asdict(got.arch) == dataclasses.asdict(want.arch)
    assert got.family == want.family == "bc" and got.arch.max_levels == 12
    assert [dataclasses.asdict(s) for s in pconfigs.BC_SHAPES] == [
        dataclasses.asdict(s) for s in jbase.BC_SHAPES]
    assert {k: dataclasses.asdict(v) for k, v in got.shapes.items()} == {
        k: dataclasses.asdict(v) for k, v in want.shapes.items()}
    assert [f.name for f in dataclasses.fields(pconfigs.BCArch)] == [
        f.name for f in dataclasses.fields(jbase.BCArch)]
    assert pconfigs.BCArch("x", 1, 2) == pconfigs.BCArch("x", 1, 2, 16, "h3", 24)
    assert pconfigs.list_archs() == [
        "bc-rmat", "codeqwen1.5-7b", "deepseek-coder-33b", "dlrm-rm2", "gat-cora", "gemma-7b",
        "gin-tu", "granite-moe-1b-a400m", "graphcast", "llama4-maverick-400b-a17b",
        "meshgraphnet"]


# ------------------------------------------------------------- static meta
@pytest.mark.parametrize("cached", [False, True], ids=["no-cache-file", "cache-file"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("shape", [s.name for s in pconfigs.BC_SHAPES])
def test_static_meta_matches_jax(shape, mesh, cached, tmp_path, monkeypatch):
    """Both shapes' meta, from the shapes and the grid alone (no graph is
    made: s25 on any machine), equals the JAX cell's on the same mesh; the
    tune report reads the same cache file (one configuration stored under
    the cell's graph key, by the port)."""
    path = tmp_path / "tune.json"
    monkeypatch.setenv("AUTOTUNE_CACHE_JSON", str(path))
    fr, R, C = MESHES[mesh]
    bundle = pconfigs.get_arch("bc-rmat")
    if cached:
        gkey = build_cell(bundle, shape, grid=(fr, R, C)).static_meta["tune"]["graph_key"]
        CostCache(path).put(gkey, "sparse|none|b16", CostRecord(level_s=1e-3, levels=4))
    got = build_cell(bundle, shape, grid=(fr, R, C))
    want = jax_build_cell(jconfigs.get_arch("bc-rmat"), shape, _jax_mesh(mesh)).static_meta
    assert isinstance(got, BCCell) and got.fn is None and got.fr == fr
    meta = dict(got.static_meta)
    meta["hbm_footprint_bytes"] = {REFERENCE_DIST_ENGINE[k]: v
                                   for k, v in meta["hbm_footprint_bytes"].items()}
    assert meta == want
    assert (meta["tune"]["cache_path"] is not None) == cached
    assert meta["tune"]["cached_configs"] == int(cached)


def test_static_meta_prices_the_paper_shapes():
    """The priced 1x1 footprints of the sparse round: s23 5.56 GiB, s25 22.25 GiB."""
    bundle = pconfigs.get_arch("bc-rmat")
    s23 = build_cell(bundle, "rmat_s23_ef16").static_meta
    s25 = build_cell(bundle, "rmat_s25_ef16").static_meta
    assert s23["n_vertices"] == 1 << 23 and s23["n_arcs"] == 32 << 23
    assert s23["sources_per_round"] == 24
    assert s23["model_flops"] == 2.0 * (32 << 23) / 2 * 24 * 2
    assert round(s23["hbm_footprint_bytes"]["sparse"] / 2**30, 2) == 5.56
    assert round(s25["hbm_footprint_bytes"]["sparse"] / 2**30, 2) == 22.25
    assert s23["hbm_footprint_bytes"]["fused"] > 2**48


# ------------------------------------------------------------ the round
def _cases(mesh):
    cases = [("h3", "cell", (_bundle(), SMALL, SEED))]
    if mesh == "2x4":
        h0 = dataclasses.replace(_bundle().arch, heuristics="h0")
        cases.append(("h0", "cell", (_bundle(h0), SMALL, SEED)))
    return cases


@pytest.fixture(scope="module")
def ranks():
    """mesh name -> every rank's ``{case: result}``, one spawn per grid."""
    cache = {}

    def get(mesh):
        if mesh not in cache:
            cache[mesh] = run_gloo(torch_cells_worker.run_cases, *MESHES[mesh],
                                   (_cases(mesh),), timeout_s=300)
        return cache[mesh]

    return get


def _jax_rounds(mesh, num_levels, inputs):
    """The JAX package's round on the cell's partition (its own copy of
    the graph, residual and partition) for each block's inputs."""
    fr, R, C = MESHES[mesh]
    cfg = jconfigs.get_arch("bc-rmat").arch
    graph = jax_rmat_graph(7, 16, seed=SEED)
    _, _, residual, omega = jax_build_schedule(graph, batch_size=cfg.batch_size,
                                               heuristics=cfg.heuristics)
    part = jax_partition_2d(residual, R, C)
    fn = jax_round_fn(part, _jax_mesh(mesh), replica_axis="pod" if fr > 1 else None,
                      num_levels=num_levels)
    omega_pad = np.zeros(part.n_pad, np.float32)
    omega_pad[: residual.n] = omega
    args = (jnp.asarray(part.src_local), jnp.asarray(part.dst_local), jnp.asarray(omega_pad))
    return [tuple(np.asarray(x) for x in fn(*args, jnp.asarray(s), jnp.asarray(d)))
            for s, d in inputs]


@pytest.mark.parametrize("mode", ["static", "liveness"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_cell_round_matches_jax(ranks, mesh, mode):
    results = ranks(mesh)
    got = results[0]["h3"]
    want = _jax_rounds(mesh, 12 if mode == "static" else None, got["inputs"])
    assert len(got[mode]) == len(want) > 1
    for (bc, ns, roots, levels), (w_bc, w_ns, w_roots, w_levels) in zip(got[mode], want):
        np.testing.assert_allclose(bc, w_bc, **TOL)
        np.testing.assert_allclose(ns, w_ns, **TOL)
        np.testing.assert_array_equal(roots, w_roots)
        np.testing.assert_array_equal(levels, w_levels)
    for rank in results[1:]:  # every rank returns the same outputs
        for mine, theirs in zip(rank["h3"][mode], got[mode]):
            for a, b in zip(mine, theirs):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_cell_static_bound_cuts_nothing_here(ranks, mesh):
    """R-MAT scale 7 is shallower than 12 levels: the static and the
    liveness rounds reach the same depth and the same BC."""
    got = ranks(mesh)[0]["h3"]
    for static, live in zip(got["static"], got["liveness"]):
        np.testing.assert_array_equal(static[3], live[3])
        assert int(live[3].max()) - 1 <= 12
        np.testing.assert_allclose(static[0], live[0], rtol=1e-6, atol=1e-6)


def test_cell_h0_run_matches_brandes(ranks):
    """Every round of an exact h0 schedule, summed: the BC of the graph."""
    got = ranks("2x4")[0]["h0"]
    n = got["residual_n"]
    bc = sum(out[0].sum(axis=0)[:n].astype(np.float64) for out in got["liveness"])
    np.testing.assert_allclose(bc, brandes_reference(rmat_graph(7, 16, seed=SEED)), **TOL)
    assert got["meta"]["n_vertices"] == n == 128


def test_cell_round_needs_its_shapes(ranks):
    got = ranks("1x1")[0]["h3"]
    sources, derived = got["inputs"][0]
    assert sources.shape == (1, 16) and derived.shape == (1, 8, 3)
    assert sources.dtype == derived.dtype == np.int32


# ------------------------------------------------------------- dispatch
def test_build_cell_dispatches_dlrm_unchanged():
    """``build_cell`` on a DLRM bundle is ``build_dlrm_cell``: the same
    cell type, meta and outputs from the same seed."""
    cfg = dataclasses.replace(pconfigs.get_arch("dlrm-rm2").arch, rows_per_table=100)
    shape = pconfigs.DLRMShape("serve_small", "serve", 8)
    bundle = pconfigs.ArchBundle(cfg, {"serve_small": shape})
    got = build_cell(bundle, "serve_small", device="cpu", seed=4)
    want = build_dlrm_cell(bundle, "serve_small", device="cpu", seed=4)
    assert isinstance(got, DLRMCell) and got.static_meta == want.static_meta
    rng = np.random.default_rng(0)
    batch = {"dense": rng.random((8, cfg.n_dense), dtype=np.float32),
             "sparse": rng.integers(0, 100, (8, cfg.n_sparse, cfg.hot_size)).astype(np.int32)}
    np.testing.assert_array_equal(got.fn(batch).numpy(), want.fn(batch).numpy())
    with pytest.raises(TypeError, match="no cell"):
        build_cell(pconfigs.ArchBundle(object(), {"x": shape}), "x")

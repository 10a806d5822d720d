"""The port's 2-D GNN message passing (``models/gnn2d.py``) and its train
cell on spawned gloo grids, against the JAX package.

Each grid (2x4 and 4x2) is spawned once per module; its ranks run every
case of that grid (tests/torch_gnn2d_worker.py) and the parametrised
tests below assert one case each.  The cases are tests/test_dist_gnn2d.py's
(the four reduced archs on a full graph, GIN on molecules, GAT on a
sampled minibatch), with the parameters of ``repro.models.gnn.init_params``
carried across: the 2-D loss and every gradient against the JAX flat
path at that file's tolerances (loss rtol 1e-4, gradients rtol 1e-3 /
atol 1e-5).  The bf16 expand / fold payloads of the cell are held against
the JAX 2-D path with the same dtypes on conftest's 8 host devices, and
the cell's train step against the JAX cell's on the same batch and
parameters.
"""
import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from repro.configs.registry import ArchBundle as JaxArchBundle, get_arch as jax_get_arch
from repro.launch.mesh import make_mesh
from repro.launch.steps import build_cell as jax_build_cell
from repro.models import gnn as jgnn
from repro.models.gnn2d import make_gnn2d_loss_fn as jax_gnn2d_loss_fn
from repro.optim import optimizers as jopt
import repro_torch.graphs as pg
from repro_torch.configs import ArchBundle, GNNShape, get_arch
from repro_torch.data import (
    NeighborSampler,
    block_budget,
    full_graph_batch,
    minibatch_batch,
    molecule_batch,
    to_2d_batch,
)
from repro_torch.distributed import run_gloo
from repro_torch.interop import gnn_params_from_jax, gnn_params_to_jax
from repro_torch.launch.steps import build_gnn_cell, gnn_cell_batch, gnn_layout
import torch_gnn2d_worker

pytestmark = pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 host devices")

MESHES = {"2x4": (1, 2, 4), "4x2": (1, 4, 2)}
ARCHS = ["graphcast", "gin-tu", "meshgraphnet", "gat-cora"]
TOL_LOSS = dict(rtol=1e-4)  # tests/test_dist_gnn2d.py:_compare's
TOL_GRAD = dict(rtol=1e-3, atol=1e-5)
# bf16 expand and fold payloads on both sides: the port's gloo sums and
# XLA's round their bf16 partial sums in other orders
TOL_BF16_LOSS = dict(rtol=2e-3)
BF16_GRAD_SHARE = 2e-2  # of each leaf's largest |gradient|
# the cell's train step, on shapes whose worst 2x4 cell fits the cell's
# max_arcs (1.5x the mean arcs a device holds)
CELL_SHAPE = GNNShape("tiny", "full_graph", 60, 240, 12, n_classes=7)
CELL_CASES = {  # case -> (arch, shape): every shape kind the cell builds
    "gin-tu": ("gin-tu", CELL_SHAPE),
    "gat-cora": ("gat-cora", CELL_SHAPE),
    "gin-tu-molecule": ("gin-tu", GNNShape("tiny", "batched_graphs", 6, 12, 10, n_classes=2,
                                           n_graphs=4)),
    "gat-cora-minibatch": ("gat-cora", GNNShape("tiny", "minibatch", 300, 2_400, 12,
                                                n_classes=5, batch_nodes=8, fanout=(3, 2))),
}
LR = 1e-3


def _reduced(get, name, **kw):
    return dataclasses.replace(get(name).arch, n_layers=2, d_hidden=8, **kw)


@functools.lru_cache(maxsize=None)
def _case(name):
    """(cfg (port), cfg (JAX), flat batch, shape kind, d_feat, d_out, n_graphs)
    of a test_dist_gnn2d.py case."""
    if name == "molecule":
        cfg, jcfg = (_reduced(g, "gin-tu") for g in (get_arch, jax_get_arch))
        batch = molecule_batch(cfg, n_graphs=6, nodes_per=8, edges_per=16, n_nodes_pad=64,
                               n_edges_pad=128, d_feat=10, d_out=2, n_classes=2, seed=2)
        return cfg, jcfg, batch, "batched_graphs", 10, 2, 6
    if name == "minibatch":
        cfg, jcfg = (_reduced(g, "gat-cora") for g in (get_arch, jax_get_arch))
        g = pg.gnp_graph(120, 0.08, seed=5)
        feats = np.random.default_rng(0).standard_normal((120, 12)).astype(np.float32)
        fanout = (4, 3)
        sampler = NeighborSampler(g, fanout, seed=1)
        n_blk, e_blk = block_budget(8, fanout)
        batch = minibatch_batch(cfg, g, feats, sampler, np.arange(8), n_blk + 8, e_blk + 8,
                                n_classes=5)
        return cfg, jcfg, batch, "minibatch", 12, 5, 0
    cfg, jcfg = (_reduced(g, name, n_vars=5) for g in (get_arch, jax_get_arch))
    d_out = 5 if cfg.kind == "graphcast" else (3 if cfg.kind == "meshgraphnet" else 7)
    batch = full_graph_batch(cfg, pg.gnp_graph(40, 0.15, seed=3), 48, 256, 12, d_out,
                             n_classes=7, seed=1)
    return cfg, jcfg, batch, "full_graph", 12, d_out, 0


@functools.lru_cache(maxsize=None)
def _jax_params(name):
    _, jcfg, _, _, d_feat, d_out, _ = _case(name)
    return jgnn.init_params(jcfg, d_feat, d_out, jax.random.PRNGKey(0))


def _flat_params(tree):
    return {k: v.numpy() for k, v in gnn_params_from_jax(jax.tree.map(np.asarray, tree)).items()}


def _b2d(name, R, C):
    _, _, batch, _, _, _, _ = _case(name)
    return to_2d_batch(batch, batch["node_feat"].shape[0], R, C)


FLAT_CASES = ARCHS + ["molecule", "minibatch"]


def _cases(mesh):
    _, R, C = MESHES[mesh]
    cases = []

    def add(tag, name, gather=None, fold=None):
        cfg, _, batch, kind, _, _, n_graphs = _case(name)
        b2d = _b2d(name, R, C)
        chunk = b2d["node_feat"].shape[0] // (R * C)
        cases.append((tag, "loss_grad", (cfg, kind, b2d, _flat_params(_jax_params(name)),
                                         chunk, b2d["src_local"].shape[2], n_graphs, gather,
                                         fold)))

    for name in FLAT_CASES:
        add(name, name)
    if mesh == "2x4":
        for name in ARCHS:
            add(f"{name}-bf16", name, "bf16", "bf16")
        for case, (name, shape) in CELL_CASES.items():
            cfg = _reduced(get_arch, name)
            cases.append((f"cell-{case}", "cell", (ArchBundle(cfg, {"tiny": shape}), "tiny", 3)))
    return cases


@pytest.fixture(scope="module")
def ranks():
    """mesh name -> every rank's ``{case: result}``, one spawn per grid."""
    cache = {}

    def get(mesh):
        if mesh not in cache:
            cache[mesh] = run_gloo(torch_gnn2d_worker.run_cases, *MESHES[mesh],
                                   (_cases(mesh),), timeout_s=400)
        return cache[mesh]

    return get


@functools.lru_cache(maxsize=None)
def _jax_flat(name):
    """The JAX flat path's loss and gradients (flat names) of a case."""
    _, jcfg, batch, kind, _, _, _ = _case(name)
    jb = jax.tree.map(jnp.asarray, batch)
    loss, grads = jax.value_and_grad(lambda p: jgnn.gnn_loss(jcfg, p, jb, kind)[0])(
        _jax_params(name))
    return float(loss), _flat_params(grads)


def _jax_mesh():
    return make_mesh((2, 4), ("data", "model"))


# ---------------------------------------------------- 2-D against flat
@pytest.mark.parametrize("name", FLAT_CASES)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_gnn2d_matches_the_jax_flat_path(ranks, mesh, name):
    """Loss and every gradient of the 2-D path (f32 payloads) against
    ``repro.models.gnn.gnn_loss`` and its ``jax.grad``."""
    got = ranks(mesh)[0][name]
    loss, grads = _jax_flat(name)
    np.testing.assert_allclose(got["loss"], loss, **TOL_LOSS)
    assert got["grads"].keys() == grads.keys()
    for key, want in grads.items():
        np.testing.assert_allclose(got["grads"][key], want, **TOL_GRAD, err_msg=key)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_every_rank_holds_the_same_loss_and_gradients(ranks, mesh):
    """The loss is replicated and the parameters' gradients summed over the
    grid: every rank ends with the same numbers, bit for bit."""
    results = ranks(mesh)
    for name, want in results[0].items():
        if not name.startswith("cell-"):
            for other in results[1:]:
                assert other[name]["loss"] == want["loss"], name
                for key, g in want["grads"].items():
                    np.testing.assert_array_equal(other[name]["grads"][key], g, err_msg=key)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_gin_step_issues_the_expand_fold_and_their_transposes(ranks, mesh):
    """GIN, 2 layers, one forward + backward: a layer's expand over the
    column group and fold over the row group, again in its recompute, and
    in the backward their transposes (the expand's reduce-scatter, the
    fold's all-gather); over the grid the loss's two sums and one
    gradient sum per parameter leaf."""
    got = ranks(mesh)[0]["gin-tu"]["collectives"]
    L, leaves = 2, len(_jax_params("gin-tu")["layers"]) + 4
    assert got == {"column/all-gather": 2 * L, "column/reduce-scatter": L,
                   "row/reduce-scatter": 2 * L, "row/all-gather": L,
                   "grid/all-reduce": 2 + leaves}


# --------------------------------------------------- bf16 payloads
@functools.lru_cache(maxsize=None)
def _jax_2d_bf16(name):
    _, jcfg, batch, kind, _, _, n_graphs = _case(name)
    b2d = _b2d(name, 2, 4)
    loss_fn, _ = jax_gnn2d_loss_fn(jcfg, _jax_mesh(), kind,
                                   chunk=b2d["node_feat"].shape[0] // 8,
                                   max_arcs=b2d["src_local"].shape[2], n_graphs=n_graphs,
                                   gather_dtype=jnp.bfloat16, fold_dtype=jnp.bfloat16)
    jb = jax.tree.map(jnp.asarray, b2d)
    loss, grads = jax.jit(jax.value_and_grad(lambda p: loss_fn(p, jb)))(_jax_params(name))
    return float(loss), _flat_params(grads)


@pytest.mark.parametrize("name", ARCHS)
def test_bf16_expand_and_fold_match_the_jax_2d_path(ranks, name):
    """The cell's payload dtypes (bf16 expand and fold, cast back to f32):
    the loss within rtol 2e-3 and each gradient within 2 % of its leaf's
    largest value of the JAX 2-D path with the same dtypes on a 2x4 host
    mesh."""
    got = ranks("2x4")[0][f"{name}-bf16"]
    loss, grads = _jax_2d_bf16(name)
    np.testing.assert_allclose(got["loss"], loss, **TOL_BF16_LOSS)
    for key, want in grads.items():
        err = np.abs(got["grads"][key] - want).max()
        assert err <= BF16_GRAD_SHARE * np.abs(want).max() + 1e-7, (key, err)


# ----------------------------------------------------------- the cell
@pytest.mark.parametrize("case", sorted(CELL_CASES))
def test_cell_train_step_matches_the_jax_cell(ranks, case):
    """One step of ``build_gnn_cell`` (a full graph, molecules, a sampled
    minibatch) on the gloo 2x4 grid against the JAX cell's ``train_step`` (``build_cell`` on a 2x4 mesh) from the same
    parameters (the port cell's, carried across) and the same 2-D batch
    (the port's host functions, bit-equal to the reference's): the loss
    within rtol 2e-3, AdamW's first moment (0.1 · the gradient) within
    2 % of each leaf's largest value, and the parameters within one step
    of lr of each other."""
    name, shape = CELL_CASES[case]
    got = ranks("2x4")[0][f"cell-{case}"]
    jcfg = _reduced(jax_get_arch, name)
    jbundle = JaxArchBundle(jcfg, {"tiny": shape})
    cell = jax_build_cell(jbundle, "tiny", _jax_mesh())
    chunk, max_arcs = gnn_layout(shape, 2, 4)
    assert (got["chunk"], got["max_arcs"]) == (chunk, max_arcs)
    assert got["meta"] == cell.static_meta
    # the cell's own batch, rebuilt on the host from its seed
    flat = gnn_cell_batch(_reduced(get_arch, name), shape, seed=3)
    b2d = to_2d_batch(flat, flat["node_feat"].shape[0], 2, 4, max_arcs=max_arcs)
    params = jax.tree.map(jnp.asarray, gnn_params_to_jax(got["before"]))
    state = {"params": params, "opt": jopt.adamw(LR).init(params)}
    new_state, out = jax.jit(cell.fn)(state, jax.tree.map(jnp.asarray, b2d))
    np.testing.assert_allclose(got["loss"], float(out["loss"]), **TOL_BF16_LOSS)
    mu = _flat_params(new_state["opt"].mu)
    after = _flat_params(new_state["params"])
    for key in mu:
        err = np.abs(got["mu"][key] - mu[key]).max()
        assert err <= BF16_GRAD_SHARE * np.abs(mu[key]).max() + 1e-8, (key, err)
        np.testing.assert_allclose(got["after"][key], after[key], rtol=0, atol=2 * LR + 1e-6,
                                   err_msg=key)
    moved = max(np.abs(got["after"][k] - got["before"][k]).max() for k in mu)
    assert 0.5 * LR < moved <= 1.01 * LR  # AdamW's first step: about lr per entry


def test_cell_refuses_replicas_and_other_archs():
    """A GNN cell runs on an R x C grid: a sub-cluster grid and a non-GNN
    arch are refused before anything is built."""

    class Groups:
        fr, R, C = 2, 1, 1

    with pytest.raises(ValueError, match="replicas"):
        build_gnn_cell(get_arch("gin-tu"), "molecule", Groups(), device="cpu")
    with pytest.raises(TypeError, match="not a GNN arch"):
        build_gnn_cell(get_arch("bc-rmat"), "rmat_s23_ef16", Groups(), device="cpu")

"""The port's GNN slice on one device against the JAX package: the configs,
``Graph.csr``, the neighbour sampler, the graph batches and their 2-D
deal (bit-equal on the same seeds), the flat message passing
(``models/gnn.py``: the loss against ``repro.models.gnn.gnn_loss`` within
rtol 1e-5, every gradient against its ``jax.grad`` within rtol 1e-4 /
atol 1e-6, with the reference's parameters carried across), one AdamW
step against the reference's update (rtol 1e-5), the parameter and
optimizer-state interop, and the GNN cells' meta against the JAX cells'.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.configs.base as jbase
import repro.graphs as jgraphs
from repro.configs.registry import get_arch as jax_get_arch
from repro.data import graphs as jdata
from repro.data.sampler import NeighborSampler as JaxSampler, block_budget as jax_block_budget
from repro.models import gnn as jgnn
from repro.optim import optimizers as jopt
import repro_torch.configs as pconfigs
import repro_torch.graphs as pgraphs
from repro_torch.configs import get_arch
from repro_torch.data import graphs as pdata
from repro_torch.data.sampler import NeighborSampler, block_budget
from repro_torch.interop import (
    gnn_optimizer_state_from_jax,
    gnn_optimizer_state_to_jax,
    gnn_params_from_jax,
    gnn_params_to_jax,
)
from repro_torch.launch.steps import build_cell, gnn_layout, gnn_static_meta, gnn_workload
from repro_torch.models import gnn as pgnn
from repro_torch.optim import adamw

ARCHS = ["gat-cora", "gin-tu", "graphcast", "meshgraphnet"]
SHAPES = [s.name for s in jbase.GNN_SHAPES]
TOL_LOSS = dict(rtol=1e-5)
TOL_GRAD = dict(rtol=1e-4, atol=1e-6)


def _reduced(get, name, **kw):
    return dataclasses.replace(get(name).arch, n_layers=2, d_hidden=8, **kw)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree) -> dict[str, np.ndarray]:
    return {k: v.numpy() for k, v in gnn_params_from_jax(_np_tree(tree)).items()}


def _assert_batches_equal(got: dict, want: dict):
    assert got.keys() == want.keys()
    for key, value in want.items():
        value = np.asarray(value)
        assert got[key].dtype == value.dtype and got[key].shape == value.shape, key
        np.testing.assert_array_equal(got[key], value, err_msg=key)


# ---------------------------------------------------------------- configs
def test_gnn_configs_match_jax_field_by_field():
    for cls in ("GNNArch", "GNNShape"):
        assert [f.name for f in dataclasses.fields(getattr(pconfigs, cls))] == [
            f.name for f in dataclasses.fields(getattr(jbase, cls))]
    assert [dataclasses.asdict(s) for s in pconfigs.GNN_SHAPES] == [
        dataclasses.asdict(s) for s in jbase.GNN_SHAPES]
    for name in ARCHS:
        got, want = get_arch(name), jax_get_arch(name)
        assert dataclasses.asdict(got.arch) == dataclasses.asdict(want.arch)
        assert got.family == want.family == "gnn"
        assert {k: dataclasses.asdict(v) for k, v in got.shapes.items()} == {
            k: dataclasses.asdict(v) for k, v in want.shapes.items()}
    ogb = get_arch("gin-tu").shapes["ogb_products"]
    assert dataclasses.asdict(ogb) == dataclasses.asdict(
        jax_get_arch("gin-tu").shapes["ogb_products"])
    assert (ogb.n_nodes, ogb.n_edges, ogb.d_feat, ogb.n_classes) == (
        2_449_029, 61_859_140, 100, 47)


# ------------------------------------------------------- graphs, sampler
GRAPHS = {
    "gnp": lambda m: m.gnp_graph(60, 0.1, seed=2),
    "rmat": lambda m: m.rmat_graph(7, 4, seed=1),
    "isolated": lambda m: m.disjoint_union(m.path_graph(5), m.Graph.from_edges(4, np.zeros((0, 2)))),
}


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_csr_is_bit_equal(graph):
    got = GRAPHS[graph](pgraphs).csr()
    want = GRAPHS[graph](jgraphs).csr()
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_sized_rmat_graph_has_the_asked_size_and_skew():
    g = pgraphs.sized_rmat_graph(2_708, 10_556, seed=0)
    assert g.n == 2_708 and g.num_arcs == 10_556
    assert np.all(g.src != g.dst)
    fwd = set(zip(g.src.tolist(), g.dst.tolist()))
    assert len(fwd) == g.num_arcs and all((v, u) in fwd for u, v in fwd)
    deg = g.degrees()
    assert deg.max() > 20 * deg.mean()  # R-MAT's heavy tail
    again = pgraphs.sized_rmat_graph(2_708, 10_556, seed=0)
    np.testing.assert_array_equal(g.src, again.src)
    assert not np.array_equal(g.src, pgraphs.sized_rmat_graph(2_708, 10_556, seed=1).src)
    with pytest.raises(ValueError, match="even"):
        pgraphs.sized_rmat_graph(10, 7)


@pytest.mark.parametrize("n,n_arcs", [(2_708, 10_556), (500, 12_000), (30, 64), (5, 20)])
def test_sized_mesh_graph_has_the_asked_size_and_bounded_degrees(n, n_arcs):
    g = pgraphs.sized_mesh_graph(n, n_arcs, seed=0)
    assert g.n == n and g.num_arcs == n_arcs and np.all(g.src != g.dst)
    fwd = set(zip(g.src.tolist(), g.dst.tolist()))
    assert len(fwd) == g.num_arcs and all((v, u) in fwd for u, v in fwd)
    deg = g.degrees()
    assert deg.max() <= 2 * (-(-n_arcs // (2 * n)) + 4)  # a few lattice displacements
    if n == 2_708:
        assert deg.max() == 4  # Cora's 3.9 arcs a vertex: the lattice's 4-neighbourhood
    np.testing.assert_array_equal(g.dst, pgraphs.sized_mesh_graph(n, n_arcs, seed=0).dst)
    with pytest.raises(ValueError, match="even"):
        pgraphs.sized_mesh_graph(n, n_arcs + 1)


def test_mesh_gnn_sums_overflow_at_an_rmat_hub_as_the_reference_does():
    """meshgraphnet at its published width (15 x 128) on a Cora-sized
    graph: on ``sized_rmat_graph`` (max degree ~300) its unnormalised sums
    overflow f32 at init in the reference's arithmetic and in the port's
    alike (loss inf); on ``sized_mesh_graph`` (degree 4), the graph its
    cells use, both losses are finite and agree (rtol 1e-5)."""
    cfg, jcfg = get_arch("meshgraphnet").arch, jax_get_arch("meshgraphnet").arch
    spec = get_arch("meshgraphnet").shapes["full_graph_sm"]
    params = jgnn.init_params(jcfg, spec.d_feat, 3, jax.random.PRNGKey(0))
    port = {k: v for k, v in gnn_params_from_jax(_np_tree(params)).items()}
    losses = {}
    for name, make in (("rmat", pgraphs.sized_rmat_graph), ("mesh", pgraphs.sized_mesh_graph)):
        g = make(spec.n_nodes, spec.n_edges, seed=0)
        batch = pdata.full_graph_batch(cfg, g, g.n, g.num_arcs, spec.d_feat, 3, 7, seed=0)
        want = float(jgnn.gnn_loss(jcfg, params, jax.tree.map(jnp.asarray, batch),
                                   "full_graph")[0])
        with torch.no_grad():
            got = pgnn.gnn_loss(cfg, port, _torch_batch(batch), "full_graph")[0].item()
        losses[name] = (got, want)
    assert losses["rmat"] == (np.inf, np.inf)
    got, want = losses["mesh"]
    assert np.isfinite(want)
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("fanout", [(15, 10), (4, 3), (5,), (2, 2, 2)])
def test_block_budget_matches(fanout):
    assert block_budget(1024, fanout) == jax_block_budget(1024, fanout)


@pytest.mark.parametrize("graph", ["gnp", "isolated"])
def test_neighbor_sampler_draws_the_same_blocks(graph):
    """Three blocks in a row from one sampler (the generator's stream
    carries over), bit-equal to the reference's."""
    got = NeighborSampler(GRAPHS[graph](pgraphs), (4, 3), seed=5)
    want = JaxSampler(GRAPHS[graph](jgraphs), (4, 3), seed=5)
    n = GRAPHS[graph](pgraphs).n
    for targets in (np.arange(4), np.array([n - 1, 0, 2]), np.arange(n)):
        a, b = got.sample(targets), want.sample(targets)
        _assert_batches_equal(dataclasses.asdict(a), dataclasses.asdict(b))


def test_neighbor_sampler_budget_and_validity():
    """tests/test_substrates.py's check, on the port's sampler."""
    g = pgraphs.gnp_graph(60, 0.1, seed=2)
    fanout = (5, 3)
    sampler = NeighborSampler(g, fanout, seed=0)
    block = sampler.sample(np.arange(8))
    n_nodes, n_edges = block_budget(8, fanout)
    assert len(block.node_ids) == n_nodes
    assert len(block.edge_src) == n_edges
    assert block.edge_src.max() < n_nodes and block.edge_dst.max() < n_nodes
    adj = {(int(u), int(v)) for u, v in zip(g.src, g.dst)}
    gids = block.node_ids
    for s_, d_ in zip(block.edge_src, block.edge_dst):
        u, v = int(gids[s_]), int(gids[d_])
        assert (u, v) in adj or u == v


# ------------------------------------------------------------ the batches
def _batches(m, name):
    """Every batch kind of data/graphs.py for arch ``name``, from module
    ``m`` (the port's or the reference's) and its graphs and sampler."""
    cfg = _reduced(get_arch if m is pdata else jax_get_arch, name, n_vars=5)
    gm = pgraphs if m is pdata else jgraphs
    sampler_cls = NeighborSampler if m is pdata else JaxSampler
    g = gm.gnp_graph(40, 0.15, seed=3)
    out = {"full": m.full_graph_batch(cfg, g, 48, 256, 12, 5, n_classes=7, seed=1),
           "molecule": m.molecule_batch(cfg, n_graphs=6, nodes_per=8, edges_per=16,
                                        n_nodes_pad=64, n_edges_pad=128, d_feat=10, d_out=2,
                                        n_classes=2, seed=2)}
    g2 = gm.gnp_graph(120, 0.08, seed=5)
    feats = m.synth_features(120, 12, seed=4)
    n_blk, e_blk = (jax_block_budget if m is jdata else block_budget)(8, (4, 3))
    for tag, labels in (("minibatch", None),
                        ("minibatch-labels", np.arange(120, dtype=np.int32) % 5)):
        out[tag] = m.minibatch_batch(cfg, g2, feats, sampler_cls(g2, (4, 3), seed=1),
                                     np.arange(8), n_blk + 8, e_blk + 8, n_classes=5,
                                     labels=labels, seed=6)
    return out


@pytest.mark.parametrize("name", ARCHS)
def test_batches_are_bit_equal(name):
    got, want = _batches(pdata, name), _batches(jdata, name)
    for kind in want:
        _assert_batches_equal(got[kind], want[kind])
    np.testing.assert_array_equal(pdata.synth_features(7, 3, seed=9),
                                  jdata.synth_features(7, 3, seed=9))


@pytest.mark.parametrize("grid", [(1, 1), (2, 4), (4, 2), (3, 1)])
@pytest.mark.parametrize("name", ARCHS)
def test_to_2d_batch_is_bit_equal(name, grid):
    got, want = _batches(pdata, name), _batches(jdata, name)
    for kind in want:
        n = want[kind]["node_feat"].shape[0]
        _assert_batches_equal(pdata.to_2d_batch(got[kind], n, *grid),
                              jdata.to_2d_batch(want[kind], n, *grid))
    full = want["full"]
    real = int(((full["edge_src"] < 48) & (full["edge_dst"] < 48)).sum())
    _assert_batches_equal(pdata.to_2d_batch(got["full"], 48, *grid, max_arcs=real),
                          jdata.to_2d_batch(full, 48, *grid, max_arcs=real))


def test_edge_budget_too_small_is_refused():
    cfg = get_arch("gin-tu").arch
    with pytest.raises(ValueError, match="edge budget too small"):
        pdata.full_graph_batch(cfg, pgraphs.gnp_graph(20, 0.5, seed=0), 20, 10, 4, 2, 2)


# ------------------------------------------------------------- the model
def _smoke_batch(kind_cfg, kind="full_graph", n=24, e=60, d_feat=12, d_out=5, mask=False):
    """tests/test_arch_smoke.py's random batch (no sentinel arcs; masks
    only where that file sets them, or everywhere with ``mask``)."""
    rng = np.random.default_rng(0)
    batch = {"node_feat": rng.standard_normal((n, d_feat)).astype(np.float32),
             "edge_src": rng.integers(0, n, e).astype(np.int32),
             "edge_dst": rng.integers(0, n, e).astype(np.int32)}
    if kind_cfg.kind in ("graphcast", "meshgraphnet"):
        batch["target"] = rng.standard_normal((n, d_out)).astype(np.float32)
        if kind_cfg.kind == "meshgraphnet":
            batch["edge_feat"] = rng.standard_normal((e, d_feat)).astype(np.float32)
    elif kind == "batched_graphs":
        batch["graph_ids"] = (np.arange(n) // (n // 4)).astype(np.int32)
        batch["labels"] = rng.integers(0, d_out, 4).astype(np.int32)
    else:
        batch["labels"] = rng.integers(0, d_out, n).astype(np.int32)
        batch["label_mask"] = np.ones(n, np.float32)
    if mask:
        batch["label_mask"] = (rng.random(n) < 0.7).astype(np.float32)
    return batch


def _cases():
    """name -> (arch, shape kind, batch maker(cfg) -> (batch, d_feat, d_out))."""
    cases = {}
    for name in ARCHS:
        cases[f"{name}-full"] = (name, "full_graph", lambda cfg: (
            pdata.full_graph_batch(cfg, pgraphs.gnp_graph(40, 0.15, seed=3), 48, 256, 12,
                                   5 if cfg.kind == "graphcast" else (
                                       3 if cfg.kind == "meshgraphnet" else 7),
                                   n_classes=7, seed=1),
            12, 5 if cfg.kind == "graphcast" else (3 if cfg.kind == "meshgraphnet" else 7)))
        cases[f"{name}-smoke"] = (name, "full_graph", lambda cfg: (_smoke_batch(cfg), 12, 5))
    cases["gin-tu-molecule"] = ("gin-tu", "batched_graphs", lambda cfg: (
        pdata.molecule_batch(cfg, n_graphs=6, nodes_per=8, edges_per=16, n_nodes_pad=64,
                             n_edges_pad=128, d_feat=10, d_out=2, n_classes=2, seed=2), 10, 2))
    cases["gin-tu-molecule-nomask"] = ("gin-tu", "batched_graphs", lambda cfg: (
        _smoke_batch(cfg, "batched_graphs"), 12, 5))
    cases["gat-cora-molecule-mask"] = ("gat-cora", "batched_graphs", lambda cfg: (
        _smoke_batch(cfg, "batched_graphs", mask=True), 12, 5))

    def minibatch(cfg):
        g = pgraphs.gnp_graph(120, 0.08, seed=5)
        feats = np.random.default_rng(0).standard_normal((120, 12)).astype(np.float32)
        n_blk, e_blk = block_budget(8, (4, 3))
        return pdata.minibatch_batch(cfg, g, feats, NeighborSampler(g, (4, 3), seed=1),
                                     np.arange(8), n_blk + 8, e_blk + 8, n_classes=5), 12, 5

    cases["gat-cora-minibatch"] = ("gat-cora", "minibatch", minibatch)
    cases["gin-tu-minibatch"] = ("gin-tu", "minibatch", minibatch)
    cases["graphcast-masked"] = ("graphcast", "full_graph", lambda cfg: (
        _smoke_batch(cfg, mask=True), 12, 5))
    return cases


CASES = _cases()


def _setup(case):
    name, kind, make = CASES[case]
    cfg, jcfg = _reduced(get_arch, name, n_vars=5), _reduced(jax_get_arch, name, n_vars=5)
    batch, d_feat, d_out = make(cfg)
    params = jgnn.init_params(jcfg, d_feat, d_out, jax.random.PRNGKey(0))
    return cfg, jcfg, kind, batch, params


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _port_loss_grads(cfg, kind, batch, params):
    tp = {k: v.requires_grad_(True) for k, v in gnn_params_from_jax(_np_tree(params)).items()}
    loss, metrics = pgnn.gnn_loss(cfg, tp, _torch_batch(batch), kind)
    loss.backward()
    return loss, metrics, {k: v.grad.numpy() for k, v in tp.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_flat_loss_and_gradients_match_jax(case):
    cfg, jcfg, kind, batch, params = _setup(case)
    jb = jax.tree.map(jnp.asarray, batch)
    (want, jm), jgrads = jax.value_and_grad(
        lambda p: jgnn.gnn_loss(jcfg, p, jb, kind), has_aux=True)(params)
    loss, metrics, grads = _port_loss_grads(cfg, kind, batch, params)
    np.testing.assert_allclose(loss.item(), float(want), **TOL_LOSS)
    assert metrics.keys() == jm.keys()
    want_grads = _flat(jgrads)
    assert grads.keys() == want_grads.keys()
    for key, g in want_grads.items():
        np.testing.assert_allclose(grads[key], g, **TOL_GRAD, err_msg=key)
    out = pgnn.gnn_forward(cfg, {k: torch.from_numpy(v) for k, v in _flat(params).items()},
                           _torch_batch(batch))
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(jgnn.gnn_forward(jcfg, params, jb)), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("name", ARCHS)
def test_adamw_step_matches_the_reference(name):
    """One ``adamw(1e-3)`` step of the port's optimizer over the port's
    parameters against the reference's update, both from the reference's
    gradients (AdamW's first step moves an entry by lr · g / |g|, so an
    entry whose gradient is at rounding level moves by up to lr either
    way: the gradients themselves are held in the test above): the
    parameters within rtol 1e-5, and the state carried to the JAX layout
    (step, μ, ν) equal to the reference's within rtol 1e-5."""
    cfg, jcfg, kind, batch, params = _setup(f"{name}-full")
    jb = jax.tree.map(jnp.asarray, batch)
    jgrads = jax.grad(lambda p: jgnn.gnn_loss(jcfg, p, jb, kind)[0])(params)
    opt = jopt.adamw(1e-3)
    new_params, new_state = opt.update(jgrads, opt.init(params), params)

    tp = {k: v.requires_grad_(True) for k, v in gnn_params_from_jax(_np_tree(params)).items()}
    popt = adamw(tp.values(), 1e-3)
    for key, g in gnn_params_from_jax(_np_tree(jgrads)).items():
        tp[key].grad = g
    popt.step()
    got = {k: v.detach().numpy() for k, v in tp.items()}
    for key, want in _flat(new_params).items():
        np.testing.assert_allclose(got[key], want, rtol=1e-5, atol=1e-7, err_msg=key)
    state = gnn_optimizer_state_to_jax(popt, tp)
    assert int(state["step"]) == int(new_state.step) == 1
    for slot in ("mu", "nu"):
        want = _flat(getattr(new_state, slot))
        for key, value in gnn_params_from_jax(jax.tree.map(
                lambda t: t.detach().numpy(), state[slot])).items():
            np.testing.assert_allclose(value.numpy(), want[key], rtol=1e-5, atol=1e-12,
                                       err_msg=f"{slot} {key}")


@pytest.mark.parametrize("name", ARCHS)
def test_interop_round_trips_bitwise(name):
    """Parameters and AdamW state: JAX tree -> port -> JAX tree, bit for
    bit, the port's tree of views (no copy), and a restored state taking
    the same next step as the original."""
    cfg, jcfg, kind, batch, params = _setup(f"{name}-full")
    tree = _np_tree(params)
    port = gnn_params_from_jax(tree)
    assert sorted(port) == sorted(pgnn.param_specs(cfg, 12, port["dec_b"].shape[0]))
    back = gnn_params_to_jax(port)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a.numpy(), b)
    assert back["layers"][next(iter(back["layers"]))] is port[next(
        k for k in port if k.startswith("layers."))]

    def stepped(tp):
        opt = adamw(tp.values(), 1e-3)
        pgnn.gnn_loss(cfg, tp, _torch_batch(batch), kind)[0].backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        return opt

    a = {k: v.clone().requires_grad_(True) for k, v in port.items()}
    opt_a = stepped(a)
    saved = jax.tree.map(lambda t: t.detach().clone().numpy(), gnn_optimizer_state_to_jax(
        opt_a, a))
    b = {k: v.detach().clone().requires_grad_(True) for k, v in a.items()}
    opt_b = adamw(b.values(), 1e-3)
    gnn_optimizer_state_from_jax(opt_b, b, saved)
    for opt, tp in ((opt_a, a), (opt_b, b)):
        pgnn.gnn_loss(cfg, tp, _torch_batch(batch), kind)[0].backward()
        opt.step()
    for key in a:
        assert torch.equal(a[key], b[key]), key


@pytest.mark.parametrize("name", ARCHS)
def test_init_params_follow_the_reference_specs(name):
    """The port's draw: the reference's shapes and keys, zero biases and ε,
    each weight a truncated normal at fan-in std over its spec's axis,
    deterministic in the generator's seed."""
    cfg = get_arch(name).arch
    d_feat, d_out = 100, pgnn.output_dim(cfg, get_arch(name).shapes["ogb_products"])
    specs = jax.eval_shape(lambda: jgnn.init_params(
        jax_get_arch(name).arch, d_feat, d_out, jax.random.PRNGKey(0), abstract=True))
    params = pgnn.init_params(cfg, d_feat, d_out, torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in params.items()} == {
        k: tuple(v.shape) for k, v in gnn_params_from_jax(jax.tree.map(
            lambda s: np.zeros(s.shape, np.float32), specs)).items()}
    assert pgnn.n_params(cfg, d_feat, d_out) == sum(
        int(np.prod(s.shape)) for s in jax.tree.leaves(specs))
    for key, (shape, axis) in pgnn.param_specs(cfg, d_feat, d_out).items():
        p = params[key]
        assert p.dtype == torch.float32 and p.requires_grad
        if axis is None:
            assert not p.any(), key
        else:
            std = shape[axis] ** -0.5
            assert p.abs().max() <= 2 * std + 1e-6 and p.std() > 0.5 * std, key
    again = pgnn.init_params(cfg, d_feat, d_out, torch.Generator().manual_seed(0))
    assert all(torch.equal(params[k], again[k]) for k in params)


def test_segment_max_of_an_empty_segment_is_minus_inf():
    x = torch.tensor([[1.0, -2.0], [3.0, -5.0], [-1.0, 4.0]])
    idx = torch.tensor([0, 0, 2], dtype=torch.int32)
    got = pgnn.segment_max(x, idx, 4)
    want = np.asarray(jax.ops.segment_max(jnp.asarray(x.numpy()), jnp.asarray(idx.numpy()),
                                          num_segments=4))
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.isinf(got[1]).all() and (got[1] < 0).all()


# ------------------------------------------------------------ the cells
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", ARCHS)
def test_cell_meta_matches_the_jax_cell(name, shape):
    """``build_cell(..., grid=...)`` builds the meta alone (no graph, no
    parameters), equal to the JAX cell's ``static_meta`` on a 2x4 mesh."""
    if jax.device_count() < 8:
        pytest.skip("needs 8 host devices")
    from repro.launch.mesh import make_mesh
    from repro.launch.steps import build_cell as jax_build_cell

    cell = build_cell(get_arch(name), shape, grid=(1, 2, 4))
    assert cell.fn is None and cell.params is None
    want = jax_build_cell(jax_get_arch(name), shape, make_mesh((2, 4), ("data", "model")))
    assert cell.static_meta == want.static_meta
    assert cell.name == want.name
    assert cell.static_meta == gnn_static_meta(get_arch(name).arch, get_arch(name).shapes[shape])


@pytest.mark.parametrize("shape", SHAPES)
def test_gnn_layout_is_the_jax_cells(shape):
    """chunk = ceil(nodes / p), max_arcs = 1.5 · arcs / p + 8 padded to 8 —
    for ogb_products on one device 92 788 720 arc slots."""
    s = get_arch("gin-tu").shapes[shape]
    n_nodes, n_edges = gnn_workload(s)
    for R, C in ((1, 1), (2, 4), (4, 2)):
        chunk, max_arcs = gnn_layout(s, R, C)
        assert chunk == -(-n_nodes // (R * C)) and max_arcs % 8 == 0
        assert int(1.5 * n_edges / (R * C)) + 8 <= max_arcs < int(1.5 * n_edges / (R * C)) + 16
    if shape == "ogb_products":
        assert gnn_layout(s, 1, 1) == (2_449_029, 92_788_720)


def test_gnn_workload_is_the_jax_cells():
    """The reference cell's workload and the port's agree on every shape
    (the minibatch block, the molecule union)."""
    from repro.launch.steps import _gnn_workload

    for s in pconfigs.GNN_SHAPES:
        assert gnn_workload(s) == _gnn_workload(s)


@pytest.mark.parametrize("kind", ["full_graph", "minibatch", "batched_graphs"])
@pytest.mark.parametrize("name", ARCHS)
def test_gnn2d_batch_specs_match_jax(name, kind):
    from repro.models.gnn2d import gnn2d_batch_specs as jax_specs
    from repro_torch.models.gnn2d import gnn2d_batch_specs

    args = (kind, 64, 2, 4, 40, 12, 5)
    got = gnn2d_batch_specs(get_arch(name).arch, *args, n_graphs=6)
    want = jax_specs(jax_get_arch(name).arch, *args, n_graphs=6)
    assert {k: (shape, str(dt).removeprefix("torch.")) for k, (shape, dt) in got.items()} == {
        k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}

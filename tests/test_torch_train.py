"""The port's DLRM training path and its substrate against the JAX package,
on the CPU.

Held against ``repro``: the schedules (equal at float32), the optimizers
over 5 steps on identical numpy gradients with a rank-3 leaf (the
reference's ``_layerwise`` slices) and the global-norm clip, against the
reference's update jitted as a train step runs it (rtol 1e-6 / atol
1e-7: the same float32 formulas, contracted into fused multiply-adds
where XLA's compiled update contracts them, rounded in another order in
the last bit elsewhere), int8 compression with error feedback (payload, scales and
residual bit-equal), the DLRM loss and every gradient against
``jax.value_and_grad(dlrm_loss)`` and 3 train-cell steps against 3 JAX
``train_step``s (rtol 1e-5 / atol 1e-6 and 1e-5: float32 sums in another
order), checkpoints that either package writes and the other resumes
(the same next step), the ``Checkpointer``'s format and guarantees and
the ``Prefetcher``.  K7's order-fixed gradient is held against autograd
through its plain version, ``ref.segment_bag_ref`` (rtol 1e-6 / atol
1e-7).  The reduced config keeps RM2's 13 dense features and changes
the widths that set the cost: 5 fields, D = 8, 3 ids a bag (−1 padding,
Zipf(1.2) ids: hot rows), 300 rows a table, MLPs 13-16-8 / 23-16-1.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.checkpoint import Checkpointer as JaxCheckpointer
from repro.configs import base as jax_base
from repro.configs import get_arch as jax_get_arch
from repro.configs.registry import ArchBundle as JaxArchBundle
from repro.data.pipeline import Prefetcher as JaxPrefetcher
from repro.distributed import compression as jcomp
from repro.launch.steps import build_cell as jax_build_cell
from repro.models import dlrm as jdlrm
from repro import optim as joptim
from repro_torch import optim
from repro_torch.checkpoint import CheckpointManager, Checkpointer
from repro_torch.configs import ArchBundle, DLRMShape, get_arch
from repro_torch.data import ClickLogStream, Prefetcher
from repro_torch.distributed import compression
from repro_torch.interop import (
    dlrm_params_from_arrays,
    dlrm_params_to_jax,
    optimizer_state_from_jax,
    optimizer_state_to_jax,
)
from repro_torch.kernels import ops, ref
from repro_torch.launch.steps import build_dlrm_cell, make_optimizer
from repro_torch.models import DLRM, dlrm_loss

SMALL = dict(n_sparse=5, embed_dim=8, bot_mlp=(16, 8), top_mlp=(16, 1), rows_per_table=300,
             hot_size=3)
B = 64
OPTIMIZERS = ["adamw", "adamw_clip", "adafactor", "sgd_momentum"]


def _small(get):
    return dataclasses.replace(get("dlrm-rm2").arch, **SMALL)


def _np(tree):
    """A JAX state (dicts and NamedTuples of arrays) as nested dicts of numpy."""
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree)


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol)


def _batch(cfg, step, with_padding=True):
    """ClickLogStream's batch (Zipf ids, the same bytes in both packages),
    a few ids turned into padding."""
    batch = ClickLogStream(cfg, B, seed=1).batch_at(step)
    if with_padding:
        batch["sparse"][::7, :, -1] = -1
    return batch


# -------------------------------------------------------------- schedules
SCHEDULES = {
    "constant": (lambda m: m.constant(3e-4), range(0, 3)),
    "linear_warmup": (lambda m: m.linear_warmup(1e-2, 7), range(0, 12)),
    "cosine": (lambda m: m.cosine_with_warmup(1e-3, 10, 100, floor=1e-5), range(0, 110, 3)),
    "cosine_no_warmup": (lambda m: m.cosine_with_warmup(0.5, 0, 37), range(0, 40)),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_equal_the_reference_at_float32(name):
    make, steps = SCHEDULES[name]
    mine, theirs = make(optim), make(joptim)
    for step in steps:
        want = np.float32(theirs(jnp.int32(step)))
        got = mine(step)
        assert np.float32(got) == want and float(np.float32(got)) == got, (step, got, want)


# ------------------------------------------------------------- optimizers
def _make(name: str, params, lib, sched):
    if name == "adamw":
        return lib.adamw(*params, lr=sched, weight_decay=0.01)
    if name == "adamw_clip":
        return lib.adamw(*params, lr=sched, grad_clip_norm=1.0)
    if name == "adafactor":
        return lib.adafactor(*params, lr=sched)
    return lib.sgd_momentum(*params, lr=sched)


@pytest.mark.parametrize("name", OPTIMIZERS)
@pytest.mark.parametrize("scheduled", [False, True], ids=["constant", "cosine"])
def test_optimizers_match_the_reference_over_five_steps(name, scheduled):
    """A rank-3 stacked leaf (updated slice by slice), a matrix, a vector
    and a scalar, 5 steps of the same numpy gradients (large enough that
    ``adamw_clip`` clips)."""
    rng = np.random.default_rng(3)
    shapes = {"stack": (3, 257, 130), "w": (33, 17), "b": (17,), "s": ()}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (2.0 * rng.standard_normal(s)).astype(np.float32) for k, s in shapes.items()}
             for _ in range(5)]
    jsched = joptim.cosine_with_warmup(1e-2, 2, 5) if scheduled else 1e-2
    tsched = optim.cosine_with_warmup(1e-2, 2, 5) if scheduled else 1e-2
    jopt = _make(name, (), joptim, jsched)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jparams)
    jupdate = jax.jit(jopt.update)  # as a train step runs it: one compiled update
    tparams = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in params.items()}
    topt = _make(name, (list(tparams.values()),), optim, tsched)
    for g in grads:
        jparams, jstate = jupdate({k: jnp.asarray(v) for k, v in g.items()}, jstate, jparams)
        for k, p in tparams.items():
            p.grad = torch.tensor(g[k])
        topt.step()
        for k, p in tparams.items():
            _close(p.detach(), jparams[k], 1e-6, 1e-7)
            for slot, jslot in _np(jstate).items():
                if slot != "step":
                    _close(topt.state[p][slot], jslot[k], 1e-6, 1e-7)
            assert topt.state[p]["step"] == int(jstate.step)


def test_adafactor_factors_the_last_two_dims_per_slice():
    p = torch.nn.Parameter(torch.zeros(3, 64, 32))
    w = torch.nn.Parameter(torch.zeros(64, 32))
    b = torch.nn.Parameter(torch.zeros(32))
    opt = optim.adafactor([p, w, b])
    assert opt.state[p]["vr"].shape == (3, 64) and opt.state[p]["vc"].shape == (3, 32)
    assert opt.state[w]["vr"].shape == (64,) and opt.state[w]["vc"].shape == (32,)
    assert opt.state[b]["vr"].shape == (32,) and opt.state[b]["vc"].shape == (1,)


@pytest.mark.parametrize("max_norm", [0.5, 1e3], ids=["clips", "passes"])
def test_global_norm_and_clip_match_the_reference(max_norm):
    rng = np.random.default_rng(4)
    tree = {"a": rng.standard_normal((5, 7)).astype(np.float32),
            "b": {"c": rng.standard_normal(11).astype(np.float32)}}
    jclipped, jnorm = joptim.clip_by_global_norm(jax.tree.map(jnp.asarray, tree), max_norm)
    tclipped, tnorm = optim.clip_by_global_norm(
        {"a": torch.tensor(tree["a"]), "b": {"c": torch.tensor(tree["b"]["c"])}}, max_norm)
    _close(tnorm, jnorm, 1e-6, 0)
    _close(optim.global_norm([torch.tensor(tree["a"]), torch.tensor(tree["b"]["c"])]), jnorm,
           1e-6, 0)
    _close(tclipped["a"], jclipped["a"], 1e-6, 1e-7)
    _close(tclipped["b"]["c"], jclipped["b"]["c"], 1e-6, 1e-7)


# ------------------------------------------------------------ compression
def test_compress_tree_is_bit_equal_to_the_reference_with_error_feedback():
    """Three steps of error feedback on a tree with a ragged leaf (not a
    multiple of the 256 block), an all-zero leaf (scale 0) and a nested
    dict: int8 payload, scales and residual bit-equal every step."""
    rng = np.random.default_rng(5)
    shapes = {"w": (130, 7), "z": (300,), "n": {"t": (2, 3, 200)}}

    def draw(tree):
        if isinstance(tree, dict):
            return {k: draw(v) for k, v in tree.items()}
        return (rng.standard_normal(tree) * 1e-3).astype(np.float32)

    grads = [draw(shapes) for _ in range(3)]
    for g in grads:
        g["z"][:] = 0.0
    jres = jcomp.init_residual(jax.tree.map(jnp.asarray, grads[0]))
    tres = compression.init_residual(jax.tree.map(torch.tensor, grads[0]))
    for g in grads:
        jq, jres = jcomp.compress_tree(jax.tree.map(jnp.asarray, g), jres)
        tq, tres = compression.compress_tree(jax.tree.map(torch.tensor, g), tres)
        for path in (("w",), ("z",), ("n", "t")):
            jt, tt = jq, tq
            jr, tr = jres, tres
            for key in path:
                jt, tt, jr, tr = jt[key], tt[key], jr[key], tr[key]
            assert tt.q.dtype == torch.int8 and tt.shape == jt.shape
            np.testing.assert_array_equal(tt.q.numpy(), np.asarray(jt.q))
            assert tt.scale.numpy().tobytes() == np.asarray(jt.scale).tobytes()
            assert tr.numpy().tobytes() == np.asarray(jr).tobytes()
        jd, td = jcomp.decompress_tree(jq), compression.decompress_tree(tq)
        assert td["n"]["t"].numpy().tobytes() == np.asarray(jd["n"]["t"]).tobytes()


def test_quantize_round_half_to_even_like_jnp_round():
    x = np.zeros(256, np.float32)
    x[0] = 127.0  # scale 1: the others quantize to themselves rounded
    x[1:6] = [0.5, 1.5, 2.5, -0.5, -2.5]
    tq = compression.quantize(torch.tensor(x))
    jq = jcomp.quantize(jnp.asarray(x))
    np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq.q))
    assert tq.q[0, 1:6].tolist() == [0, 2, 2, 0, -2]


# ------------------------------------------------ K7's gradient, the model
@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
def test_segment_bag_gradient_is_the_rounded_float64_sum(weighted):
    """K7's table gradient against autograd through its plain version in
    float64: the float64 sum rounded once (rtol 1e-7; atol 1e-9 for the
    float64 sum's own rounding, n·2^-53·Σ|t| ~ 1e-10 here).  The plain
    version's float32 autograd (``index_add_``) is within the bound of
    any float32 summation order, (n - 1)·2^-24·Σ|t| of each entry's n
    terms, and so is K7's; two backward passes give the same bits."""
    rng = np.random.default_rng(6)
    V, D, nb, L = 500, 24, 900, 4
    idx = ((rng.zipf(1.2, size=(nb, L)) - 1) % V).astype(np.int32)  # row 0 hot
    idx[::5, -1] = -1
    w = rng.random((nb, L)).astype(np.float32) if weighted else np.ones((nb, L), np.float32)
    weights = torch.tensor(w) if weighted else None
    table_np = rng.standard_normal((V, D)).astype(np.float32)
    up = torch.tensor(rng.standard_normal((nb, D)).astype(np.float32))
    indices = torch.tensor(idx)
    table = torch.tensor(table_np, requires_grad=True)
    grads = []
    for _ in range(2):
        table.grad = None
        out = ops.segment_bag(table, indices, weights)
        assert out.grad_fn is not None
        (out * up).sum().backward()
        grads.append(table.grad.clone())
    assert torch.equal(grads[0], grads[1])  # order-fixed: the same bits twice
    t64 = torch.tensor(table_np, dtype=torch.float64, requires_grad=True)
    w64 = None if weights is None else weights.double()
    (ref.segment_bag_ref(t64, indices, w64) * up.double()).sum().backward()
    _close(grads[0], t64.grad, 1e-7, 1e-9)
    plain = torch.tensor(table_np, requires_grad=True)
    (ref.segment_bag_ref(plain, indices, weights) * up).sum().backward()
    mask = idx >= 0
    terms = np.zeros(V)  # lookups a row
    np.add.at(terms, idx[mask], 1)
    scale = np.zeros((V, D))  # Σ|t| of each entry
    np.add.at(scale, idx[mask], np.abs(w[mask][:, None] * up.numpy()[np.nonzero(mask)[0]]))
    bound = np.maximum(terms - 1, 0)[:, None] * 2.0**-24 * scale
    for got in (plain.grad, grads[0]):
        assert (np.abs(got.numpy() - t64.grad.numpy()) <= bound + 1e-12).all()
    assert terms[0] > ops.GRAD_PIECE  # row 0 is summed in pieces
    untouched = np.setdiff1d(np.arange(V), idx[mask])
    assert float(grads[0][untouched].abs().max()) == 0.0
    with torch.no_grad():  # the forward alone records nothing
        assert ops.segment_bag(table, indices, weights).grad_fn is None


def test_segment_bag_refuses_weights_that_require_grad():
    table = torch.zeros((4, 3), requires_grad=True)
    w = torch.ones((2, 2), requires_grad=True)
    with pytest.raises(ValueError, match="weights get no gradient"):
        ops.segment_bag(table, torch.zeros((2, 2), dtype=torch.int32), w)


def test_segment_bag_gradient_of_only_padding_is_zero():
    table = torch.ones((6, 5), requires_grad=True)
    ops.segment_bag(table, torch.full((3, 2), -1, dtype=torch.int32)).sum().backward()
    assert torch.equal(table.grad, torch.zeros(6, 5))


@pytest.fixture(scope="module")
def small():
    """(JAX cfg, port cfg, JAX params, port model with the same weights)."""
    jcfg, cfg = _small(jax_get_arch), _small(get_arch)
    params = jdlrm.init_params(jcfg, jax.random.PRNGKey(0))
    model = DLRM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    model.load_state_dict(dlrm_params_from_arrays(_np(params)))
    return jcfg, cfg, params, model


def test_dlrm_loss_and_every_gradient_match_jax(small):
    jcfg, cfg, params, model = small
    batch = _batch(cfg, 0)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jdlrm.dlrm_loss(jcfg, p, _jax(batch)), has_aux=True)(params)
    model.zero_grad(set_to_none=True)
    loss, metrics = dlrm_loss(model, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    _close(loss.detach(), jloss, 1e-5, 1e-6)
    assert metrics["bce"] is loss
    grads = dlrm_params_to_jax({n: p.grad for n, p in model.named_parameters()})
    assert sorted(grads) == sorted(jgrads)
    for key, g in grads.items():
        _close(g, jgrads[key], 1e-5, 1e-6)
    assert float(grads["tables"].abs().max()) > 0.0


def _jax_train_cell(jcfg):
    shape = jax_base.DLRMShape("train_batch", "train", B)
    return jax_build_cell(JaxArchBundle(jcfg, {"train_batch": shape}), "train_batch")


def _jax_start(jcfg):
    params = jdlrm.init_params(jcfg, jax.random.PRNGKey(0))
    return {"params": params, "opt": joptim.adamw(1e-3).init(params)}


def _port_cell(cfg, jstate):
    bundle = ArchBundle(cfg, {"train_batch": DLRMShape("train_batch", "train", B)})
    cell = build_dlrm_cell(bundle, "train_batch", device="cpu")
    cell.load_train_state(_np(jstate))
    return cell


def _assert_state_close(cell, jstate, rtol, atol):
    got, want = cell.train_state(), _np(jstate)
    assert int(got["opt"]["step"]) == int(want["opt"]["step"])
    for key, value in want["params"].items():
        _close(got["params"][key].detach(), value, rtol, atol)
    for slot in ("mu", "nu"):
        for key, value in want["opt"][slot].items():
            _close(got["opt"][slot][key], value, rtol, atol)


def test_three_train_cell_steps_match_three_jax_train_steps():
    jcfg, cfg = _small(jax_get_arch), _small(get_arch)
    jcell = _jax_train_cell(jcfg)
    jstate = _jax_start(jcfg)
    cell = _port_cell(cfg, jstate)
    assert cell.static_meta == jcell.static_meta
    for step in range(3):
        batch = _batch(cfg, step)
        out = cell.fn(batch)
        jstate, jout = jcell.fn(jstate, _jax(batch))
        assert sorted(out) == sorted(jout) == ["bce", "loss"]
        _close(out["loss"], jout["loss"], 1e-5, 1e-6)
    assert all(p.grad is None for p in cell.model.parameters())  # set to None after a step
    _assert_state_close(cell, jstate, 1e-5, 1e-5)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_a_checkpoint_of_either_package_resumes_in_the_other(tmp_path, direction):
    """Two steps and a save in one package, a restore and step 3 in the
    other: equal to step 3 of a straight run (the same next step)."""
    jcfg, cfg = _small(jax_get_arch), _small(get_arch)
    jcell = _jax_train_cell(jcfg)
    straight = _jax_start(jcfg)
    for step in range(3):
        straight, _ = jcell.fn(straight, _jax(_batch(cfg, step)))
    root = str(tmp_path / "ck")
    if direction == "jax_to_port":
        jstate = _jax_start(jcfg)
        for step in range(2):
            jstate, _ = jcell.fn(jstate, _jax(_batch(cfg, step)))
        mgr = JaxCheckpointManager(root, save_every=1)
        assert mgr.maybe_save(1, jstate, {"stream_step": 2})
        cell = _port_cell(cfg, _jax_start(jcfg))
        state, meta, start = CheckpointManager(root).restore_or_init(cell.train_state())
        cell.load_train_state(state)
        assert start == 2 and meta == {"stream_step": 2}
        assert int(cell.train_state()["opt"]["step"]) == 2
        cell.fn(_batch(cfg, start))
        _assert_state_close(cell, straight, 1e-5, 1e-5)
    else:
        cell = _port_cell(cfg, _jax_start(jcfg))
        for step in range(2):
            cell.fn(_batch(cfg, step))
        mgr = CheckpointManager(root, save_every=1, async_writes=True)
        assert mgr.maybe_save(1, cell.train_state(), {"stream_step": 2})
        mgr.ckpt.close()
        state, meta, start = JaxCheckpointManager(root).restore_or_init(_jax_start(jcfg))
        assert start == 2 and meta == {"stream_step": 2} and int(state["opt"].step) == 2
        state, _ = jcell.fn(state, _jax(_batch(cfg, start)))
        want = _np(straight)
        for key, value in _np(state)["params"].items():
            _close(value, want["params"][key], 1e-5, 1e-5)


@pytest.mark.parametrize("name", ["adamw", "adafactor", "sgd_momentum"])
def test_optimizer_state_crosses_over_in_the_jax_layout(small, name):
    """Two reference steps on the DLRM's own gradients, the state carried
    into the port (Adafactor's vr / vc swapped for the [out, in]
    weights), a third step in both: equal; and back out again."""
    jcfg, cfg, params, _ = small
    jopt = {"adamw": joptim.adamw, "adafactor": joptim.adafactor,
            "sgd_momentum": joptim.sgd_momentum}[name](1e-2)
    jparams, jstate = params, jopt.init(params)
    grad_fn = jax.grad(lambda p, b: jdlrm.dlrm_loss(jcfg, p, b)[0])
    for step in range(2):
        jparams, jstate = jopt.update(grad_fn(jparams, _jax(_batch(cfg, step))), jstate, jparams)
    model = DLRM(cfg, device="cpu", generator=torch.Generator().manual_seed(9))
    model.load_state_dict(dlrm_params_from_arrays(_np(jparams)))
    named = dict(model.named_parameters())
    topt = {"adamw": optim.adamw, "adafactor": optim.adafactor,
            "sgd_momentum": optim.sgd_momentum}[name](model.parameters(), 1e-2)
    optimizer_state_from_jax(topt, named, _np(jstate))
    back = _np(optimizer_state_to_jax(topt, named))
    for slot, value in _np(jstate).items():
        if slot == "step":
            assert int(back[slot]) == int(value) == 2
        else:
            for key in value:
                assert back[slot][key].tobytes() == value[key].tobytes()
    batch = _batch(cfg, 2)
    jparams, jstate = jopt.update(grad_fn(jparams, _jax(batch)), jstate, jparams)
    loss, _ = dlrm_loss(model, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    topt.step()
    got = dlrm_params_to_jax(named)
    for key, value in _np(jparams).items():
        _close(got[key].detach(), value, 1e-5, 1e-5)
    state = _np(optimizer_state_to_jax(topt, named))
    for slot, value in _np(jstate).items():
        if slot != "step":
            for key in value:
                _close(state[slot][key], value[key], 1e-5, 1e-7)


# ------------------------------------------------------------- checkpoint
def _state():
    return {"params": {"w": torch.arange(6.0).reshape(2, 3),
                       "h": torch.tensor([1.5, -2.25, 3.0]).to(torch.bfloat16)},
            "opt": {"step": torch.tensor(7, dtype=torch.int32)}}


def test_checkpointer_round_trip_with_a_bf16_leaf_and_metadata(tmp_path):
    ck = Checkpointer(str(tmp_path))
    state = _state()
    path = ck.save(3, state, {"cursor": 42})
    assert os.path.basename(path) == "step_00000003"
    assert sorted(os.listdir(path)) == ["COMMITTED", "manifest.json", "shard_p0.npz"]
    restored, meta = ck.restore(state)
    assert meta == {"cursor": 42}
    for key in ("w", "h"):
        assert restored["params"][key].dtype == state["params"][key].dtype
        assert torch.equal(restored["params"][key], state["params"][key])
    assert restored["opt"]["step"].dtype == torch.int32 and int(restored["opt"]["step"]) == 7
    # the JAX package reads the same file: bf16 through ml_dtypes
    like = {"params": {"w": np.zeros((2, 3), np.float32), "h": np.zeros(3, np.float32)},
            "opt": {"step": np.int32(0)}}
    jrestored, jmeta = JaxCheckpointer(str(tmp_path)).restore(like)
    assert jmeta == {"cursor": 42} and int(jrestored["opt"]["step"]) == 7
    assert str(jrestored["params"]["h"].dtype) == "bfloat16"
    np.testing.assert_array_equal(np.asarray(jrestored["params"]["h"], np.float32),
                                  [1.5, -2.25, 3.0])
    np.testing.assert_array_equal(jrestored["params"]["w"], state["params"]["w"].numpy())


def test_checkpointer_restores_a_jax_bf16_leaf(tmp_path):
    JaxCheckpointer(str(tmp_path)).save(1, {"h": jnp.asarray([0.5, 7.0], jnp.bfloat16)})
    restored, _ = Checkpointer(str(tmp_path)).restore({"h": torch.zeros(2)})
    assert restored["h"].dtype == torch.bfloat16 and restored["h"].tolist() == [0.5, 7.0]


@pytest.mark.parametrize("damage", ["shard", "missing_leaf", "shape"])
def test_checkpointer_detects_corruption_and_mismatch(tmp_path, damage):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"a": torch.ones(4)})
    like = {"a": torch.ones(4)}
    if damage == "shard":
        np.savez(os.path.join(ck.step_dir(1), "shard_p0.npz"), a=np.zeros(4, np.float32))
        with pytest.raises(IOError, match="corruption in a"):
            ck.restore(like)
    elif damage == "missing_leaf":
        with pytest.raises(KeyError, match="missing leaf b"):
            ck.restore({"a": torch.ones(4), "b": torch.ones(1)})
    else:
        with pytest.raises(ValueError, match="shape mismatch"):
            ck.restore({"a": torch.ones(5)})


def test_async_save_keeps_the_values_of_its_call(tmp_path):
    """An in-place update right after an async save (CPU tensors, whose
    ``.numpy()`` would share their storage) does not reach the file."""
    ck = Checkpointer(str(tmp_path), async_writes=True)
    x = torch.zeros(1 << 16)
    p = torch.nn.Parameter(torch.zeros(3))
    for step in range(4):
        ck.save(step, {"x": x, "p": p})
        x.add_(1.0)
        with torch.no_grad():
            p.add_(2.0)
    ck.close()
    assert not ck._worker.is_alive()
    for step in range(4):
        restored, _ = ck.restore({"x": x, "p": p}, step=step)
        assert float(restored["x"].min()) == float(restored["x"].max()) == step
        assert restored["p"].tolist() == [2.0 * step] * 3


def test_manager_keeps_the_last_and_resumes_after_them(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=2, save_every=2, async_writes=True)
    x = torch.zeros(3)
    for step in range(7):
        x = x + 1
        mgr.maybe_save(step, {"x": x}, {"stream_step": step + 1})
    mgr.ckpt.close()
    assert mgr.ckpt.available_steps() == [4, 6]
    state, meta, start = mgr.restore_or_init({"x": torch.zeros(3)})
    assert start == 7 and meta == {"stream_step": 7} and state["x"].tolist() == [7.0] * 3
    fresh = {"x": torch.zeros(3)}
    assert CheckpointManager(str(tmp_path / "none")).restore_or_init(fresh) == (fresh, {}, 0)
    os.makedirs(os.path.join(str(tmp_path), "step_00000009"))  # no COMMITTED marker
    assert mgr.latest_step() == 6


# ------------------------------------------------------------- prefetcher
@pytest.mark.parametrize("start", [0, 5])
def test_prefetcher_yields_steps_in_order_like_the_reference(start):
    mine = Prefetcher(lambda s: {"x": np.full(2, s)}, depth=2, start_step=start)
    theirs = JaxPrefetcher(lambda s: {"x": np.full(2, s)}, depth=2, start_step=start)
    try:
        for k in range(6):
            (s, got), (t, want) = mine.get(), theirs.get()
            assert s == t == start + k and got["x"].tolist() == want["x"].tolist()
    finally:
        mine.close()
        theirs.close()
    assert not mine._thread.is_alive()


def test_prefetcher_surfaces_the_producers_error_and_closes():
    def producer(step):
        if step == 2:
            raise RuntimeError("boom at 2")
        return step

    pf = Prefetcher(producer, depth=4)
    assert pf.get() == (0, 0) and pf.get() == (1, 1)
    with pytest.raises(RuntimeError, match="boom at 2"):
        pf.get()
    pf.close()
    assert not pf._thread.is_alive()

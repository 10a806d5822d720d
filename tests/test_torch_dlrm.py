"""The port's DLRM serving path against the JAX package, on the CPU.

K7's plain version (through the port's CPU ``ops.segment_bag``) is held
against the JAX package's Pallas kernel in interpret mode and its
reference, over the grid of tests/test_kernels.py plus a ragged D, at
that test's tolerances: rtol 1e-6 (f32 tables) or 2e-2 (bf16), atol 1e-5
(the two sum the bag in different orders).  The lookup, the forward
(logit and feature vectors), serve, the loss and retrieval run on a
reduced RM2 (100 rows per table, 3 ids per bag) with the JAX package's
own weights carried over by ``interop.dlrm_params_from_arrays``, at rtol
1e-5 / atol 1e-6 (tests/test_arch_smoke.py's tolerance for the two
lookups).  The CUDA kernel itself is tested on the card by
tests/test_torch_gpu.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import base as jax_base
from repro.configs.registry import ArchBundle as JaxArchBundle
from repro.data.recsys import ClickLogStream as JaxClickLogStream
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.launch.steps import build_cell as jax_build_cell
from repro.models import dlrm as jdlrm
from repro_torch.configs import DLRM_SHAPES, ArchBundle, DLRMShape, get_arch, list_archs
from repro_torch.data import ClickLogStream
from repro_torch.interop import dlrm_params_from_arrays
from repro_torch.kernels import ops, ref
from repro_torch.launch.steps import build_dlrm_cell, dlrm_model_flops, dlrm_n_params
from repro_torch.models import DLRM, dlrm_loss, embedding_bag_lookup, retrieval_scores

BAG_SHAPES = [(32, 8, 4, 3), (64, 128, 8, 5), (128, 96, 16, 10), (1000, 64, 32, 26),
              (50, 13, 6, 4)]  # the last: a ragged D
TABLE_DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
B = 8


def _reduced(get):
    return dataclasses.replace(get("dlrm-rm2").arch, rows_per_table=100, hot_size=3)


@pytest.fixture(scope="module")
def small():
    """(JAX cfg, port cfg, JAX params, port model with the same weights, batch)."""
    jcfg, cfg = _reduced(jax_get_arch), _reduced(get_arch)
    params = jdlrm.init_params(jcfg, jax.random.PRNGKey(0))
    model = DLRM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    model.load_state_dict(dlrm_params_from_arrays({k: np.asarray(v) for k, v in params.items()}))
    model.requires_grad_(False)  # served, as the serve cells freeze theirs
    rng = np.random.default_rng(0)
    batch = {
        "dense": rng.standard_normal((B, cfg.n_dense)).astype(np.float32),
        "sparse": rng.integers(-1, cfg.rows_per_table, (B, cfg.n_sparse, cfg.hot_size))
        .astype(np.int32),
        "labels": rng.integers(0, 2, B).astype(np.float32),
        "candidates": rng.standard_normal((100, cfg.embed_dim)).astype(np.float32),
    }
    assert (batch["sparse"] == -1).any()
    return jcfg, cfg, params, model, batch


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("V,D,Bb,L", BAG_SHAPES)
@pytest.mark.parametrize("dtype", sorted(TABLE_DTYPES))
@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
def test_segment_bag_matches_jax_kernel_and_reference(V, D, Bb, L, dtype, weighted):
    tdt, jdt = TABLE_DTYPES[dtype]
    rng = np.random.default_rng(V + D + Bb + L)
    table = rng.standard_normal((V, D)).astype(np.float32)
    indices = rng.integers(-1, V, size=(Bb, L)).astype(np.int32)
    weights = rng.random((Bb, L)).astype(np.float32) if weighted else None
    jt = jnp.asarray(table, jdt)
    jw = None if weights is None else jnp.asarray(weights)
    want_kernel = np.asarray(jops.segment_bag(jt, jnp.asarray(indices), jw, interpret=True))
    want_ref = np.asarray(jref.segment_bag_ref(jt, jnp.asarray(indices), jw))
    tt = torch.from_numpy(table).to(tdt)
    tw = None if weights is None else torch.from_numpy(weights)
    got = ops.segment_bag(tt, torch.from_numpy(indices), tw)
    assert got.dtype == torch.float32 and got.shape == (Bb, D)
    torch.testing.assert_close(got, ref.segment_bag_ref(tt, torch.from_numpy(indices), tw),
                               rtol=0.0, atol=0.0)
    rtol = 2e-2 if dtype == "bf16" else 1e-6
    for want in (want_kernel, want_ref):
        np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=1e-5)


def test_segment_bag_all_padding_bag_is_zero():
    table = torch.ones((16, 8))
    indices = torch.full((3, 4), -1, dtype=torch.int32)
    indices[1, 2] = 5  # one real id among padding bags
    out = ops.segment_bag(table, indices)
    want = np.asarray(jops.segment_bag(jnp.ones((16, 8)), jnp.asarray(indices.numpy()),
                                       interpret=True))
    np.testing.assert_array_equal(out.numpy(), want)
    assert out[0].abs().sum() == 0 and out[2].abs().sum() == 0 and out[1].sum() == 8


def test_segment_bag_launches_nothing_on_the_cpu():
    before = dict(ops.LAUNCHES)
    ops.segment_bag(torch.ones((4, 4)), torch.zeros((2, 1), dtype=torch.int32))
    assert ops.LAUNCHES == before


@pytest.mark.parametrize("bad,match", [
    (dict(table=torch.ones((4, 4), dtype=torch.float64)), "float32 or bfloat16"),
    (dict(table=torch.ones((4,))), r"\[V, D\]"),
    (dict(indices=torch.zeros((2, 1), dtype=torch.int64)), "int32"),
    (dict(indices=torch.zeros((2,), dtype=torch.int32)), r"\[B, L\]"),
    (dict(weights=torch.ones((2, 1), dtype=torch.float64)), "weights must be float32"),
    (dict(weights=torch.ones((2, 2))), "like indices"),
    (dict(table=torch.ones((4, 8))[:, ::2]), "contiguous"),
])
def test_segment_bag_rejects_what_the_kernel_does_not_take(bad, match):
    args = dict(table=torch.ones((4, 4)), indices=torch.zeros((2, 1), dtype=torch.int32),
                weights=None)
    args.update(bad)
    with pytest.raises((TypeError, ValueError), match=match):
        ops.segment_bag(args["table"], args["indices"], args["weights"])


@pytest.mark.parametrize("use_pallas", [False, True], ids=["xla-gather", "pallas"])
def test_embedding_bag_lookup_matches_both_jax_branches(small, use_pallas):
    jcfg, _, params, model, batch = small
    want = jdlrm.embedding_bag_lookup(jcfg, params["tables"], jnp.asarray(batch["sparse"]),
                                      use_pallas=use_pallas)
    got = embedding_bag_lookup(model.tables, torch.from_numpy(batch["sparse"]))
    assert got.shape == (B, jcfg.n_sparse, jcfg.embed_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_forward_matches_jax(small):
    jcfg, _, params, model, batch = small
    want_logit, want_feats = jdlrm.dlrm_forward(jcfg, params, jnp.asarray(batch["dense"]),
                                                jnp.asarray(batch["sparse"]))
    with torch.no_grad():
        logit, feats = model(torch.from_numpy(batch["dense"]), torch.from_numpy(batch["sparse"]))
    assert logit.shape == (B,) and feats.shape == (B, jcfg.n_sparse + 1, jcfg.embed_dim)
    np.testing.assert_allclose(logit.numpy(), np.asarray(want_logit), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(feats.numpy(), np.asarray(want_feats), rtol=1e-5, atol=1e-6)


def test_loss_matches_jax(small):
    jcfg, _, params, model, batch = small
    want, want_m = jdlrm.dlrm_loss(jcfg, params, _jax(batch))
    with torch.no_grad():
        got, got_m = dlrm_loss(model, _torch(batch))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-6)
    assert float(got_m["bce"]) == float(got) and np.isfinite(float(want_m["bce"]))


def _small_bundle(cfg):
    return ArchBundle(arch=cfg, shapes={
        "serve_small": DLRMShape("serve_small", "serve", B),
        "retrieval_small": DLRMShape("retrieval_small", "retrieval", B, n_candidates=100),
    })


def test_serve_cell_matches_jax_serve(small):
    jcfg, cfg, params, model, batch = small
    cell = build_dlrm_cell(_small_bundle(cfg), "serve_small", device="cpu", seed=3)
    assert cell.model.tables.device.type == "cpu"
    cell.model.load_state_dict(model.state_dict())
    want = jax.nn.sigmoid(jdlrm.dlrm_forward(jcfg, params, jnp.asarray(batch["dense"]),
                                             jnp.asarray(batch["sparse"]))[0])
    got = cell.fn(batch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="sparse must be"):
        cell.fn({**batch, "sparse": batch["sparse"][:, :, :1].copy()})


def test_retrieval_top7_matches_jax(small):
    jcfg, _, params, model, batch = small
    want_s, want_i = jdlrm.retrieval_scores(jcfg, params, _jax(batch), top_k=7)
    with torch.no_grad():
        got_s, got_i = retrieval_scores(model, _torch(batch), top_k=7)
    want_s, want_i = np.asarray(want_s), np.asarray(want_i)
    np.testing.assert_allclose(got_s.numpy(), want_s, rtol=1e-5, atol=1e-5)
    # ids agree wherever a score is not tied (within tolerance) with a neighbour
    gap = np.diff(want_s, axis=1)
    untied = np.ones_like(want_s, dtype=bool)
    untied[:, 1:] &= np.abs(gap) > 1e-4
    untied[:, :-1] &= np.abs(gap) > 1e-4
    assert untied.mean() > 0.5
    np.testing.assert_array_equal(got_i.numpy()[untied], want_i[untied])


def test_retrieval_cell_pads_candidates_to_512(small):
    _, cfg, _, model, batch = small
    cell = build_dlrm_cell(_small_bundle(cfg), "retrieval_small", device="cpu")
    cell.model.load_state_dict(model.state_dict())
    cands = np.zeros((512, cfg.embed_dim), np.float32)
    cands[:100] = batch["candidates"]
    scores, ids = cell.fn({**batch, "candidates": cands})
    assert scores.shape == ids.shape == (B, 100)
    with torch.no_grad():
        want_s, _ = retrieval_scores(model, _torch({**batch, "candidates": cands}), top_k=100)
    torch.testing.assert_close(scores, want_s, rtol=0.0, atol=0.0)
    with pytest.raises(ValueError, match="candidates must be"):
        cell.fn(batch)  # unpadded


def test_cells_of_several_shapes_share_one_model():
    cfg = _reduced(get_arch)
    serve = build_dlrm_cell(_small_bundle(cfg), "serve_small", device="cpu")
    retrieval = build_dlrm_cell(_small_bundle(cfg), "retrieval_small", device="cpu",
                                model=serve.model)
    assert retrieval.model is serve.model
    other = dataclasses.replace(cfg, rows_per_table=50)
    with pytest.raises(ValueError, match="was built for"):
        build_dlrm_cell(_small_bundle(other), "serve_small", device="cpu", model=serve.model)


def test_config_copies_match_jax_field_by_field():
    assert list_archs() == [
        "bc-rmat", "codeqwen1.5-7b", "deepseek-coder-33b", "dlrm-rm2", "gat-cora", "gemma-7b",
        "gin-tu", "granite-moe-1b-a400m", "graphcast", "llama4-maverick-400b-a17b",
        "meshgraphnet"]
    got, want = get_arch("dlrm-rm2"), jax_get_arch("dlrm-rm2")
    assert dataclasses.asdict(got.arch) == dataclasses.asdict(want.arch)
    assert got.arch.rows_per_table == 10_485_760 and got.arch.hot_size == 1
    assert got.family == want.family == "recsys"
    assert [dataclasses.asdict(s) for s in DLRM_SHAPES] == [
        dataclasses.asdict(s) for s in jax_base.DLRM_SHAPES]
    assert got.shapes.keys() == want.shapes.keys()


@pytest.mark.parametrize("step", [0, 1, 7])
def test_click_log_stream_is_byte_identical(step):
    jcfg, cfg = jax_get_arch("dlrm-rm2").arch, get_arch("dlrm-rm2").arch
    got = ClickLogStream(cfg, 64, seed=3).batch_at(step)
    want = JaxClickLogStream(jcfg, 64, seed=3).batch_at(step)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape
        assert got[key].tobytes() == want[key].tobytes()


@pytest.mark.parametrize("shape_name", [s.name for s in DLRM_SHAPES])
def test_model_flops_and_params_equal_the_jax_cells(shape_name):
    bundle, jbundle = get_arch("dlrm-rm2"), jax_get_arch("dlrm-rm2")
    want = jax_build_cell(jbundle, shape_name).static_meta
    assert dlrm_model_flops(bundle.arch, bundle.shapes[shape_name]) == want["model_flops"]
    assert dlrm_n_params(bundle.arch) == want["n_params"]
    shapes = {shape_name: bundle.shapes[shape_name]}  # the port's cell, on a reduced RM2
    got = build_dlrm_cell(ArchBundle(_reduced(get_arch), shapes), shape_name,
                          device="cpu").static_meta
    jshapes = {shape_name: jbundle.shapes[shape_name]}
    assert got == jax_build_cell(JaxArchBundle(_reduced(jax_get_arch), jshapes),
                                 shape_name).static_meta


def test_build_dlrm_cell_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None is the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_dlrm_cell(_small_bundle(_reduced(get_arch)), "serve_small")


def test_train_cell_is_not_ported_yet():
    """The train cell builds now (the name is the one this test had while
    it raised): a trainable model with AdamW state in the JAX layout,
    and serve cells still freeze the model they build."""
    reduced = _reduced(get_arch)
    cell = build_dlrm_cell(ArchBundle(reduced, {"train_batch": get_arch("dlrm-rm2")
                                                .shapes["train_batch"]}), "train_batch",
                           device="cpu")
    assert cell.optimizer is not None and cell.model.training
    assert all(p.requires_grad for p in cell.model.parameters())
    state = cell.train_state()
    assert sorted(state["opt"]) == ["mu", "nu", "step"] and int(state["opt"]["step"]) == 0
    assert state["params"]["bot_w0"].shape == (reduced.n_dense, reduced.bot_mlp[0])
    serve = build_dlrm_cell(_small_bundle(reduced), "serve_small", device="cpu")
    assert not any(p.requires_grad for p in serve.model.parameters())
    with pytest.raises(ValueError, match="not a train cell"):
        serve.train_state()


def test_same_seed_same_parameters_and_dense_init_statistics():
    cfg = _reduced(get_arch)
    a = DLRM(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    b = DLRM(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    w = a.top[0].weight.detach()  # [512, 415]: fan-in 415
    assert w.shape == (512, 415)
    assert float(w.abs().max()) <= 2.0 * 415**-0.5 + 1e-7
    assert abs(float(w.std()) * 415**0.5 - 0.88) < 0.02  # std of N(0,1) cut at ±2
    assert float(a.top[0].bias.detach().abs().max()) == 0.0
    assert abs(float(a.tables.detach().std()) * cfg.embed_dim**0.5 - 1.0) < 0.05

"""The port's LM training forward, loss and gradients against the JAX
package, on the CPU.

Every LM arch, reduced as tests/test_arch_smoke.py reduces it
(``reduced_lm(layers=2, d_model=128, vocab=512)``), with the JAX
package's own weights (``init_params(PRNGKey(0))``) carried over by
``interop.lm_params_from_jax``; tokens from a numpy seed.  B = 2 and
S = 256: a 255-token loss, one chunk of 128 and a ragged tail of 127.

Tolerances, in bf16 units (the two packages round the same bf16
activations in other orders, a unit or two a layer; see
tests/test_torch_lm_serve.py):
- ``TOL_LOSS`` (1e-2 relative) on the loss, its CE and its aux term;
- ``TOL_GRAD`` (5 %) on each gradient leaf, as a share of the JAX
  gradient's largest |value|: bf16 weights' gradients are bf16 sums of
  bf16 products, each accumulated in another order.  For an MoE arch
  the gradients are compared with the port's routes held to the
  reference's own (its expert ids, captured from its jitted
  ``value_and_grad`` through ``jax.lax.top_k``, forward and recompute
  equal): a route is a discontinuous function of its input, and with
  top-1 (llama4-maverick) a token at a near-tie that a bf16 unit sends
  to another expert moves the whole gradient — the reference's own
  gradients move by 21 % (embed) and 28 % (a layer leaf) of their
  largest value when its norms move by 1e-4, where granite's and
  gemma's move by 1.4-1.9 %.  Unheld, at most ``MOE_FLIPS`` (1 %) of
  the port's tokens may go to another set of experts than the
  reference's (the order within a set, which sets the aux loss's top-1
  and the bf16 combine order, may differ at near-ties);
- the MoE's expert ids and slots equal as integers on the reference's
  own FFN inputs, and the MoE FFN's vector-Jacobian product on those
  inputs within ``TOL_GRAD``;
- ``bmm_f32``'s backward within one bf16 unit of the value plus 1e-5 of
  the sum of |terms| of ``jax.vjp`` of the reference's
  ``preferred_element_type=f32`` einsum (both the f32 cotangent product,
  rounded once to bf16, summed in another order: cancellation does not
  shrink the sum's rounding).

Exact: the port's loss and every gradient with ``remat`` on and off
(recomputing a layer gives the same bits).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.launch.train import reduced_lm as jax_reduced_lm
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro_torch.configs import get_arch
from repro_torch.interop import lm_params_from_jax, lm_params_to_jax
from repro_torch.launch.train import reduced_lm
from repro_torch.models import TransformerLM, attention, moe
from repro_torch.models.transformer import lm_loss
from torch_lm_routes import jax_routes, port_routes

LM_ARCHS = ["gemma-7b", "codeqwen1.5-7b", "deepseek-coder-33b", "granite-moe-1b-a400m",
            "llama4-maverick-400b-a17b"]
MOE_ARCHS = ["granite-moe-1b-a400m", "llama4-maverick-400b-a17b"]
TOL_LOSS, TOL_GRAD, MOE_FLIPS = 1e-2, 5e-2, 0.01
B, S = 2, 256


def _reduce(get, name, **changes):
    cfg = (jax_reduced_lm if get is jax_get_arch else reduced_lm)(
        get(name).arch, layers=2, d_model=128, vocab=512)
    return dataclasses.replace(cfg, **changes)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _share(got, want) -> float:
    """max |got − want| / max |want|."""
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def _rel(got, want) -> float:
    got, want = float(_f32(got)), float(_f32(want))
    return abs(got - want) / abs(want)


def _tokens(seq: int, vocab: int = 512) -> np.ndarray:
    return np.random.default_rng(0).integers(0, vocab, (B, seq)).astype(np.int32)


def _model(cfg, params) -> TransformerLM:
    model = TransformerLM(cfg, device="cpu", trainable=True)
    model.load_state_dict(lm_params_from_jax(cfg, _np(params)))
    return model


@functools.lru_cache(maxsize=None)
def _params(name):
    return jtf.init_params(_reduce(jax_get_arch, name), jax.random.PRNGKey(0))


def _jax_loss_and_grads(jcfg, params, tokens):
    fn = jax.jit(jax.value_and_grad(lambda p, t: jtf.lm_loss(jcfg, p, t), has_aux=True))
    with jax_routes(jcfg) as routes:
        (loss, metrics), grads = fn(params, jnp.asarray(tokens))
        jax.block_until_ready(grads)
    return loss, metrics, grads, routes


def _port_loss_and_grads(model, tokens):
    model.zero_grad(set_to_none=True)
    loss, metrics = lm_loss(model, torch.from_numpy(tokens))
    loss.backward()
    grads = lm_params_to_jax(model)
    grads = {"embed": grads["embed"].grad, "ln_f": grads["ln_f"].grad,
             "layers": {k: p.grad for k, p in grads["layers"].items()}}
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def _assert_grads_close(got, want):
    flat = {"embed": got["embed"], "ln_f": got["ln_f"], **got["layers"]}
    wflat = {"embed": want["embed"], "ln_f": want["ln_f"], **want["layers"]}
    assert flat.keys() == wflat.keys()
    for key, g in flat.items():
        assert g is not None and g.dtype == lm_dtype(wflat[key]), key
        assert float(np.abs(_f32(wflat[key])).max()) > 0.0, key
        assert _share(g, wflat[key]) <= TOL_GRAD, (key, _share(g, wflat[key]))


def lm_dtype(leaf) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[str(leaf.dtype)]


def _check_against_jax(name, seq, **changes):
    jcfg, cfg = _reduce(jax_get_arch, name, **changes), _reduce(get_arch, name, **changes)
    params, tokens = _params(name), _tokens(seq)
    jloss, jmetrics, jgrads, jroutes = _jax_loss_and_grads(jcfg, params, tokens)
    model = _model(cfg, params)
    with port_routes(model) as own:
        loss, metrics, grads = _port_loss_and_grads(model, tokens)
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert _rel(loss, jloss) <= TOL_LOSS and _rel(metrics["ce"], jmetrics["ce"]) <= TOL_LOSS
    if cfg.moe is None:
        assert float(metrics["aux"]) == float(jmetrics["aux"]) == 0.0
        assert torch.equal(loss, metrics["ce"])
        assert own == jroutes == []
    else:
        assert _rel(metrics["aux"], jmetrics["aux"]) <= TOL_LOSS
        assert len(own) == len(jroutes) == cfg.n_layers
        flips = np.mean([np.any(np.sort(a) != np.sort(b), axis=-1).mean()  # expert sets
                         for a, b in zip(own, jroutes)])
        assert flips <= MOE_FLIPS, flips
        with port_routes(model, jroutes):  # the gradients on the reference's routes
            loss, metrics, grads = _port_loss_and_grads(model, tokens)
        assert _rel(loss, jloss) <= TOL_LOSS
    _assert_grads_close(grads, jgrads)


# ------------------------------------------------------------ lm_loss + grad
@pytest.mark.parametrize("name", LM_ARCHS)
def test_lm_loss_and_every_gradient_match_jax(name):
    """S = 256: one chunk of 128 and a 127-token ragged tail, remat on."""
    _check_against_jax(name, S)


@pytest.mark.parametrize("name,seq,chunk", [("gemma-7b", 129, 128),  # one chunk, no tail
                                            ("granite-moe-1b-a400m", 64, 128),  # S-1 < chunk
                                            ("codeqwen1.5-7b", 256, 64)])  # 3 chunks + tail
def test_lm_loss_chunking_without_and_with_a_tail_matches_jax(name, seq, chunk):
    _check_against_jax(name, seq, loss_chunk=chunk)


@pytest.mark.parametrize("name", LM_ARCHS)
def test_remat_on_and_off_give_the_same_bits(name):
    runs = []
    for remat in (True, False):
        cfg = _reduce(get_arch, name, remat=remat)
        runs.append(_port_loss_and_grads(_model(cfg, _params(name)), _tokens(S)))
    (loss_a, met_a, g_a), (loss_b, met_b, g_b) = runs
    assert torch.equal(loss_a, loss_b)
    assert all(torch.equal(met_a[k], met_b[k]) for k in met_a)
    for key in ("embed", "ln_f"):
        assert torch.equal(g_a[key], g_b[key]), key
    for key in g_a["layers"]:
        assert torch.equal(g_a["layers"][key], g_b["layers"][key]), key


def test_a_frozen_model_takes_no_gradient():
    cfg = _reduce(get_arch, "gemma-7b")
    model = TransformerLM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    assert not model.trainable and not any(p.requires_grad for p in model.parameters())
    loss, _ = lm_loss(model, torch.from_numpy(_tokens(64)))
    assert not loss.requires_grad and bool(torch.isfinite(loss))


# ------------------------------------------------------------- the pieces
def test_bmm_f32_backward_is_the_reference_f32_cotangent_product():
    rng = np.random.default_rng(1)
    a = rng.standard_normal((3, 40, 64)).astype(np.float32)
    b = rng.standard_normal((3, 64, 50)).astype(np.float32)
    g = rng.standard_normal((3, 40, 50)).astype(np.float32)
    ja, jb = jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)
    out, vjp = jax.vjp(lambda x, y: jnp.einsum("nmk,nkp->nmp", x, y,
                                               preferred_element_type=jnp.float32), ja, jb)
    ga, gb = vjp(jnp.asarray(g))
    ta = torch.from_numpy(a).bfloat16().requires_grad_()
    tb = torch.from_numpy(b).bfloat16().requires_grad_()
    got = attention.bmm_f32(ta, tb)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_f32(got), _f32(out), rtol=1e-6, atol=1e-5)
    got.backward(torch.from_numpy(g))
    assert ta.grad.dtype == tb.grad.dtype == torch.bfloat16
    scales = (np.abs(g) @ np.abs(_f32(jb)).transpose(0, 2, 1),
              np.abs(_f32(ja)).transpose(0, 2, 1) @ np.abs(g))
    for mine, ref, scale in zip((ta.grad, tb.grad), (ga, gb), scales):
        err = np.abs(_f32(mine) - _f32(ref))
        assert np.all(err <= 2.0**-7 * np.abs(_f32(ref)) + 1e-5 * scale)
    with pytest.raises(ValueError, match="out="):
        attention.bmm_f32(ta, tb, out=torch.empty(3, 40, 50))


@pytest.mark.parametrize("window", [None, 100])
def test_causal_attention_gradients_match_jax(window):
    """Two q-chunks (the concatenated path), GQA 4 heads on 2 kv heads."""
    rng = np.random.default_rng(2)
    q, k, v, ct = (rng.standard_normal((2, 256, h, 64)).astype(np.float32)
                   for h in (4, 2, 2, 4))
    bf = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    out, vjp = jax.vjp(lambda *a: jattn.causal_attention(*a, q_chunk=128, window=window), *bf)
    want = vjp(jnp.asarray(ct, jnp.bfloat16))
    tq, tk, tv = (torch.from_numpy(x).bfloat16().requires_grad_() for x in (q, k, v))
    got = attention.causal_attention(tq, tk, tv, q_chunk=128, window=window)
    assert _share(got, out) <= TOL_GRAD / 5
    got.backward(torch.from_numpy(ct).bfloat16())
    for t, w in zip((tq, tk, tv), want):
        assert _share(t.grad, w) <= TOL_GRAD


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_routes_and_vjp_match_jax_on_the_reference_inputs(name):
    """Each layer's FFN input as the reference's layer computes it (from the
    reference's own residual): the expert ids and slots equal as integers,
    and the MoE FFN's vector-Jacobian product (output and aux) on it."""
    jcfg = _reduce(jax_get_arch, name)
    params, tokens = _params(name), _tokens(S)
    positions = jnp.broadcast_to(jnp.arange(S), (B, S))
    x = params["embed"][tokens].astype(jnp.bfloat16)
    rng = np.random.default_rng(3)
    m = jcfg.moe
    for l in range(jcfg.n_layers):
        lp = jax.tree.map(lambda w: w[l], params["layers"])
        # the attention half of the reference's layer, its own lines
        h = jlayers.rms_norm(x, lp["ln1"])
        q = (h @ lp["wq"]).reshape(B, S, jcfg.n_heads, jcfg.head_dim)
        kk = (h @ lp["wk"]).reshape(B, S, jcfg.n_kv_heads, jcfg.head_dim)
        v = (h @ lp["wv"]).reshape(B, S, jcfg.n_kv_heads, jcfg.head_dim)
        o = jattn.causal_attention(jlayers.rope(q, positions, jcfg.rope_theta),
                                   jlayers.rope(kk, positions, jcfg.rope_theta), v,
                                   q_chunk=jcfg.q_chunk, window=jcfg.attn_window)
        mid = x + o.reshape(B, S, -1) @ lp["wo"]
        hin = jlayers.rms_norm(mid, lp["ln2"]).reshape(B * S, -1)

        def ffn(hh, r, wi, wo):
            return jmoe.moe_ffn(hh, r, wi, wo, top_k=m.top_k,
                                capacity_factor=m.capacity_factor, activation=jcfg.activation)

        (y, aux), vjp = jax.vjp(ffn, hin, lp["router"], lp["wi_e"], lp["wo_e"])
        ct = rng.standard_normal(y.shape).astype(np.float32)
        want = vjp((jnp.asarray(ct, jnp.bfloat16), jnp.float32(1.0)))

        th = torch.from_numpy(_f32(hin)).bfloat16().requires_grad_()
        ws = [torch.from_numpy(np.array(lp[k]).view(np.int16)).view(torch.bfloat16)
              if lp[k].dtype == jnp.bfloat16 else torch.from_numpy(np.array(lp[k]))
              for k in ("router", "wi_e", "wo_e")]
        ws = [w.requires_grad_() for w in ws]
        _, _, ids = moe.route(th.detach(), ws[0].detach(), m.top_k)
        probs = jax.nn.softmax(hin.astype(jnp.float32) @ lp["router"], axis=-1)
        _, jids = jax.lax.top_k(probs, m.top_k)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
        flat = jnp.asarray(jids).reshape(-1)
        onehot = jax.nn.one_hot(flat, m.num_experts, dtype=jnp.int32)
        jpos = jnp.take_along_axis(jnp.cumsum(onehot, axis=0) - onehot, flat[:, None],
                                   axis=1)[:, 0]
        np.testing.assert_array_equal(moe.expert_slots(ids.reshape(-1), m.num_experts).numpy(),
                                      np.asarray(jpos))
        ty, taux = moe.moe_ffn(th, *ws, top_k=m.top_k, capacity_factor=m.capacity_factor,
                               activation=jcfg.activation)
        assert _share(ty, y) <= TOL_GRAD / 5 and _rel(taux, aux) <= TOL_LOSS
        torch.autograd.backward([ty, taux], [torch.from_numpy(ct).bfloat16(), torch.tensor(1.0)])
        for t, w in zip([th, *ws], want):
            assert t.grad.dtype == lm_dtype(w)
            assert _share(t.grad, w) <= TOL_GRAD, (l, _share(t.grad, w))
        x = mid + y.reshape(B, S, -1)

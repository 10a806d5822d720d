"""The port's LM serving path against the JAX package, on the CPU.

Every LM arch, reduced as tests/test_arch_smoke.py reduces it
(``reduced_lm(layers=2, d_model=128, vocab=512)``), with the JAX
package's own weights (``init_params(PRNGKey(0))``) carried over by
``interop.lm_params_from_jax``; prompts from a numpy seed.

Tolerances, each a share of the JAX side's largest |value|:
- ``TOL_HALF`` (1 %) on each half-layer (attention, FFN) given the JAX
  package's input to it, every layer of a prefill: the bf16 drift of
  one half (the activations differ by a bf16 unit or two, see
  tests/test_torch_lm.py); the MoE's expert ids and slots equal as
  integers;
- ``TOL_LOGITS`` (5 %) on the logits and ``TOL_CACHE`` (2 %) on the KV
  cache of a whole prefill plus 8 teacher-forced decode steps (both
  sides read the same tokens): two layers of that drift.  An MoE arch
  may have ``MOE_ROWS`` (1 %) of its cache rows (one a layer, sequence
  and position) past ``TOL_CACHE``: a router input a bf16 unit off can
  send a token whose top-k sits that close to a tie to another expert,
  and then also move the token that sits at an expert's capacity; the
  half-layer test holds every MoE layer's routing exactly;
- greedy decoding (``serve_loop``) must give the reference's tokens up
  to the first step whose reference top-2 margin is below
  ``TOL_LOGITS``, and, teacher-forced on the reference's tokens, the
  same argmax wherever the margin is above it.

Exact: the configs field for field, ``LM_SHAPES``, the cell meta of
every LM arch × serving shape (built on the ``meta`` device, nothing
allocated), ``TokenStream``'s batches and the interop round trip, bit
for bit.
"""
import dataclasses
import functools
import subprocess
import sys
import tracemalloc
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import get_arch as jax_get_arch
from repro.data.tokens import TokenStream as JaxTokenStream
from repro.launch import serve_lm as jserve
from repro.launch.steps import build_cell as jax_build_cell
from repro.launch.train import reduced_lm as jax_reduced_lm
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro_torch import configs
from repro_torch.configs import ArchBundle, get_arch
from repro_torch.data import TokenStream
from repro_torch.interop import lm_params_from_jax, lm_params_to_jax
from repro_torch.launch.serve_lm import serve_loop
from repro_torch.launch.steps import build_cell, build_lm_cell
from repro_torch.launch.train import reduced_lm
from repro_torch.models import TransformerLM, cache_specs, padded_vocab, param_specs
from repro_torch.models import moe

LM_ARCHS = ["gemma-7b", "codeqwen1.5-7b", "deepseek-coder-33b", "granite-moe-1b-a400m",
            "llama4-maverick-400b-a17b"]
SERVE_SHAPES = ["prefill_32k", "decode_32k", "long_500k"]
TOL_HALF, TOL_LOGITS, TOL_CACHE, MOE_ROWS = 1e-2, 5e-2, 2e-2, 0.01
B, S, STEPS = 3, 256, 8  # two q-chunks (q_chunk 128); B > K = 2: decode a product a kv head
ROOT = Path(__file__).resolve().parents[1]


def _reduce(get, name):
    return (jax_reduced_lm if get is jax_get_arch else reduced_lm)(
        get(name).arch, layers=2, d_model=128, vocab=512)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.array(jnp.asarray(x).astype(jnp.float32))  # a writable copy


def _share(got, want) -> float:
    """max |got − want| / max |want|."""
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def _rows_off(got, want, tol: float) -> float:
    """The share of cache rows [L, B, S] whose error passes tol · max |want|."""
    diff = np.abs(_f32(got) - _f32(want)).max(axis=(-2, -1))
    return float((diff > tol * np.abs(_f32(want)).max()).mean())


@functools.lru_cache(maxsize=None)
def _arch(name):
    """(JAX cfg, port cfg, JAX params, port model with them, tokens [B, S + STEPS])."""
    jcfg, cfg = _reduce(jax_get_arch, name), _reduce(get_arch, name)
    params = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    model = TransformerLM(cfg, device="cpu")
    model.load_state_dict(lm_params_from_jax(cfg, _np(params)))
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (B, S + STEPS)).astype(np.int32)
    return jcfg, cfg, params, model, tokens


@functools.lru_cache(maxsize=None)
def _jax_run(name):
    """The JAX package's prefill of S tokens, then STEPS teacher-forced
    decode steps: (logits [STEPS + 1, B, V], prefill cache, final cache)."""
    jcfg, _, params, _, tokens = _arch(name)
    logits, cache = jax.jit(lambda p, t: jtf.prefill(jcfg, p, t))(params, tokens[:, :S])
    prefill_cache = cache
    cache = jax.tree.map(lambda c: jnp.pad(c, ((0, 0), (0, 0), (0, STEPS), (0, 0), (0, 0))),
                         cache)
    decode = jax.jit(lambda p, c, t, pos: jtf.decode_step(jcfg, p, c, t, pos))
    steps = [logits]
    for i in range(STEPS):
        logits, cache = decode(params, cache, tokens[:, S + i], jnp.int32(S + i))
        steps.append(logits)
    return np.stack([np.asarray(x) for x in steps]), _np(prefill_cache), _np(cache)


# ----------------------------------------------------------------- configs
def test_lm_configs_match_jax_field_by_field():
    for cls in ("MoESpec", "LMArch", "LMShape"):
        assert [f.name for f in dataclasses.fields(getattr(configs, cls))] == [
            f.name for f in dataclasses.fields(getattr(jbase, cls))]
    assert dataclasses.asdict(configs.LMArch("x", 1, 2, 3, 4, 5, 6, 7)) == dataclasses.asdict(
        jbase.LMArch("x", 1, 2, 3, 4, 5, 6, 7))
    assert configs.LMArch("x", 1, 2, 3, 4, 5, 6, 7).q_chunk == 512
    assert configs.MoESpec(2, 1, 3) == configs.MoESpec(2, 1, 3, 1.25)
    assert [dataclasses.asdict(s) for s in configs.LM_SHAPES] == [
        dataclasses.asdict(s) for s in jbase.LM_SHAPES]
    for name in LM_ARCHS:
        got, want = get_arch(name), jax_get_arch(name)
        assert dataclasses.asdict(got.arch) == dataclasses.asdict(want.arch)
        assert got.family == want.family == "lm"
        assert {k: dataclasses.asdict(v) for k, v in got.shapes.items()} == {
            k: dataclasses.asdict(v) for k, v in want.shapes.items()}
        assert dataclasses.asdict(reduced_lm(got.arch, 2, 128, 512)) == dataclasses.asdict(
            jax_reduced_lm(want.arch, 2, 128, 512))


def test_param_and_cache_specs_match_jax():
    for name in LM_ARCHS:
        cfg, jcfg = get_arch(name).arch, jax_get_arch(name).arch
        assert padded_vocab(cfg) == jtf.padded_vocab(jcfg)
        got, want = param_specs(cfg), jtf.param_specs(jcfg)
        flat = {"embed": got["embed"], "ln_f": got["ln_f"], **got["layers"]}
        wflat = {"embed": want["embed"], "ln_f": want["ln_f"], **want["layers"]}
        assert flat.keys() == wflat.keys()
        for k, (shape, dt) in flat.items():
            assert shape == wflat[k].shape and str(dt).split(".")[1] == str(wflat[k].dtype), k
        for k, (shape, dt) in cache_specs(cfg, 3, 17).items():
            assert shape == jtf.cache_specs(jcfg, 3, 17)[k].shape and dt == torch.bfloat16
        on_meta = TransformerLM(cfg, device="meta")  # nothing allocated, even for llama4
        assert sum(p.numel() for p in on_meta.parameters()) == sum(
            int(np.prod(s.shape)) for s in jax.tree.leaves(want))


@pytest.mark.parametrize("vocab,batch,seq,seed", [(512, 4, 64, 0), (49155, 2, 300, 7),
                                                  (60, 3, 5, 123)])
def test_token_stream_is_bit_equal(vocab, batch, seq, seed):
    got, want = TokenStream(vocab, batch, seq, seed), JaxTokenStream(vocab, batch, seq, seed)
    for step in (0, 1, 17, 1000):
        a, b = got.batch_at(step), want.batch_at(step)
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    for a, b, _ in zip(got, want, range(3)):
        np.testing.assert_array_equal(a, b)


# -------------------------------------------------------------------- cells
@pytest.mark.parametrize("shape", SERVE_SHAPES)
@pytest.mark.parametrize("name", LM_ARCHS)
def test_lm_cell_meta_matches_jax_without_allocating(name, shape):
    want = jax_build_cell(jax_get_arch(name), shape).static_meta
    tracemalloc.start()
    try:
        cell = build_cell(get_arch(name), shape, device="meta")
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert peak < 1 << 20  # from the shapes: no parameter, cache or graph is made
    assert cell.fn is None and cell.model is None
    assert cell.static_meta == want
    assert {k: type(v) for k, v in cell.static_meta.items()} == {
        k: type(v) for k, v in want.items()}


def test_lm_train_shape_is_the_next_slice():
    """The train shape, once the next slice, now builds its cell: the JAX
    cell's meta on the meta device, and a frozen serving model refused."""
    want = jax_build_cell(jax_get_arch("gemma-7b"), "train_4k").static_meta
    cell = build_cell(get_arch("gemma-7b"), "train_4k", device="meta")
    assert cell.static_meta == want and cell.fn is None
    _, cfg, _, model, _ = _arch("gemma-7b")
    with pytest.raises(ValueError, match="frozen"):
        build_lm_cell(_bundle(cfg, t=("train", S, B)), "t", device="cpu", model=model)


def _bundle(cfg, **shapes):
    return ArchBundle(cfg, {name: configs.LMShape(name, kind, seq, b)
                            for name, (kind, seq, b) in shapes.items()})


@pytest.mark.parametrize("name", ["gemma-7b", "granite-moe-1b-a400m"])
def test_lm_cells_run_the_model_and_match_the_jax_cells(name):
    jcfg, cfg, params, model, tokens = _arch(name)
    bundle = _bundle(cfg, pre=("prefill", S, B), dec=("decode", S + STEPS, B))
    pre = build_lm_cell(bundle, "pre", device="cpu", model=model)
    dec = build_cell(bundle, "dec", device="cpu", model=model)
    assert pre.model is dec.model is model
    logits, cache = pre.fn({"tokens": tokens[:, :S]})
    want_l, want_c = _jax_run(name)[:2]
    assert tuple(cache["k"].shape) == (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.head_dim)
    assert _share(logits, want_l[0]) <= TOL_LOGITS
    # the JAX decode cell, one step, on the same (padded) cache
    jbundle = jbase.LMShape("dec", "decode", S + STEPS, B)
    jcell = jax_build_cell(type(jax_get_arch(name))(jcfg, {"dec": jbundle}), "dec")
    padded = {k: np.pad(np.asarray(v), ((0, 0), (0, 0), (0, STEPS), (0, 0), (0, 0)))
              for k, v in want_c.items()}
    jl, _ = jcell.fn(params, padded, {"tokens": tokens[:, S], "pos": jnp.int32(S)})
    pc = dec.empty_cache()
    for k in pc:
        pc[k][:, :, :S] = cache[k]
    got_l, pc2 = dec.fn(pc, {"tokens": tokens[:, S], "pos": S})
    assert pc2["k"] is pc["k"]  # updated in place
    assert _share(got_l, jl) <= TOL_LOGITS
    with pytest.raises(ValueError, match="tokens must be"):
        pre.fn({"tokens": tokens[:, :S - 1]})
    with pytest.raises(ValueError, match="cache must hold"):
        dec.fn(model.empty_cache(B, S), {"tokens": tokens[:, S], "pos": S})
    other = dataclasses.replace(cfg, n_layers=1)
    with pytest.raises(ValueError, match="was built for"):
        build_lm_cell(_bundle(other, pre=("prefill", S, B)), "pre", device="cpu", model=model)


# ------------------------------------------------------------------ interop
@pytest.mark.parametrize("name", LM_ARCHS)
def test_interop_round_trip_is_bitwise(name):
    _, cfg, params, model, _ = _arch(name)
    back = lm_params_to_jax(model)
    want = _np(params)
    for key in ("embed", "ln_f"):
        np.testing.assert_array_equal(_bits(back[key]), np.asarray(want[key]).view(
            np.int16) if want[key].dtype.name == "bfloat16" else want[key])
    assert back["layers"].keys() == want["layers"].keys()
    for key, leaf in want["layers"].items():
        got = back["layers"][key]
        assert tuple(got.shape) == leaf.shape
        ref = leaf.view(np.int16) if leaf.dtype.name == "bfloat16" else leaf
        np.testing.assert_array_equal(_bits(got), ref)
    again = TransformerLM(cfg, device="cpu")
    again.load_state_dict(lm_params_from_jax(cfg, {
        "embed": want["embed"], "ln_f": want["ln_f"],
        "layers": {k: v for k, v in want["layers"].items()}}))
    for (n, p), (_, q) in zip(model.named_parameters(), again.named_parameters()):
        assert torch.equal(p, q), n
    bad = dict(want, ln_f=want["ln_f"][:-1])
    with pytest.raises(ValueError, match="ln_f must be"):
        lm_params_from_jax(cfg, bad)


# -------------------------------------------------------- the model, layer
def _jax_attention_half(jcfg, x, lp, positions):
    """The first half of the reference's ``_layer_fwd`` (its lines, with
    its building blocks): x + attention(x) @ wo, and the layer's k, v."""
    b, s, _ = x.shape
    h = jlayers.rms_norm(x, lp["ln1"])
    q = (h @ lp["wq"]).reshape(b, s, jcfg.n_heads, jcfg.head_dim)
    k = (h @ lp["wk"]).reshape(b, s, jcfg.n_kv_heads, jcfg.head_dim)
    v = (h @ lp["wv"]).reshape(b, s, jcfg.n_kv_heads, jcfg.head_dim)
    q = jlayers.rope(q, positions, jcfg.rope_theta)
    k = jlayers.rope(k, positions, jcfg.rope_theta)
    o = jattn.causal_attention(q, k, v, q_chunk=jcfg.q_chunk, window=jcfg.attn_window)
    return x + (o.reshape(b, s, -1) @ lp["wo"]), k, v


def _jax_ffn_half(jcfg, x, lp):
    """The second half: x + ffn(rms_norm(x)); for an MoE also its input."""
    b, s, d = x.shape
    h = jlayers.rms_norm(x, lp["ln2"])
    if jcfg.moe is None:
        return x + jlayers.ACTIVATIONS[jcfg.activation](h @ lp["wi"]) @ lp["wo_mlp"], None
    y, _ = jmoe.moe_ffn(h.reshape(b * s, d), lp["router"], lp["wi_e"], lp["wo_e"],
                        top_k=jcfg.moe.top_k, capacity_factor=jcfg.moe.capacity_factor,
                        activation=jcfg.activation)
    return x + y.reshape(b, s, d), h.reshape(b * s, d)


@pytest.mark.parametrize("name", LM_ARCHS)
def test_prefill_halves_match_jax_teacher_forced(name):
    jcfg, cfg, params, model, tokens = _arch(name)
    toks = tokens[:, :S]
    positions = jnp.broadcast_to(jnp.arange(S), (B, S))
    x = params["embed"][toks].astype(jnp.bfloat16)
    cache = model.empty_cache(B, S)
    for l in range(cfg.n_layers):
        lp = jax.tree.map(lambda w: w[l], params["layers"])
        mid, k, v = _jax_attention_half(jcfg, x, lp, positions)
        out, h = _jax_ffn_half(jcfg, mid, lp)
        # the halves are the reference's layer, bit for bit
        whole, (wk, _, _) = jtf._layer_fwd(jcfg, x, lp, positions)
        np.testing.assert_array_equal(_f32(whole), _f32(out))
        np.testing.assert_array_equal(_f32(wk), _f32(k))

        tx = torch.from_numpy(_f32(x)).bfloat16()
        got_mid = model.prefill_attention(l, tx, cache)
        assert _share(got_mid, mid) <= TOL_HALF, (l, "attention")
        assert _share(cache["k"][l], k) <= TOL_HALF and _share(cache["v"][l], v) <= TOL_HALF
        got_out = model.ffn_block(l, torch.from_numpy(_f32(mid)).bfloat16())
        assert _share(got_out, out) <= TOL_HALF, (l, "ffn")
        if h is not None:  # the routing of the reference's MoE input, as integers
            th = torch.from_numpy(_f32(h)).bfloat16()
            _, _, ids = moe.route(th, model.layers[l].router, jcfg.moe.top_k)
            probs = jax.nn.softmax(h.astype(jnp.float32) @ lp["router"], axis=-1)
            _, jids = jax.lax.top_k(probs, jcfg.moe.top_k)
            np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
            flat = jnp.asarray(jids).reshape(-1)
            onehot = jax.nn.one_hot(flat, jcfg.moe.num_experts, dtype=jnp.int32)
            jpos = jnp.take_along_axis(jnp.cumsum(onehot, axis=0) - onehot, flat[:, None],
                                       axis=1)[:, 0]
            np.testing.assert_array_equal(
                moe.expert_slots(ids.reshape(-1), jcfg.moe.num_experts).numpy(),
                np.asarray(jpos))
        x = out
    tx = torch.from_numpy(_f32(jlayers.rms_norm(x, params["ln_f"])[:, -1])).bfloat16()
    want = (jlayers.rms_norm(x, params["ln_f"])[:, -1] @ params["embed"].T).astype(jnp.float32)
    got = (tx @ model.embed.T).float()
    assert _share(got, want) <= TOL_HALF


@pytest.mark.parametrize("name", LM_ARCHS)
def test_prefill_and_decode_match_jax(name):
    _, cfg, _, model, tokens = _arch(name)
    want_logits, want_pre, want_cache = _jax_run(name)
    t = torch.from_numpy(tokens)
    logits, cache = model.prefill(t[:, :S], max_seq=S + STEPS)
    assert logits.dtype == torch.float32 and tuple(logits.shape) == (B, padded_vocab(cfg))
    allowed = MOE_ROWS if cfg.moe is not None else 0.0
    steps = [logits]
    for key in ("k", "v"):  # the prefill fills the cache in place, no padded copy
        assert cache[key].shape[2] == S + STEPS
        assert _rows_off(cache[key][:, :, :S], want_pre[key], TOL_CACHE) <= allowed
        assert not cache[key][:, :, S:].any()
    for i in range(STEPS):
        logits, cache = model.decode_step(cache, t[:, S + i], S + i)
        steps.append(logits)
    for i, got in enumerate(steps):
        for row in range(B):
            assert _share(got[row], want_logits[i][row]) <= TOL_LOGITS, (i, row)
    for key in ("k", "v"):
        assert _rows_off(cache[key], want_cache[key], TOL_CACHE) <= allowed
        assert _rows_off(cache[key][0], want_cache[key][0], TOL_CACHE) == 0.0  # before any MoE


@pytest.mark.parametrize("name", ["gemma-7b", "granite-moe-1b-a400m"])
def test_serve_loop_matches_jax_teacher_forced(name):
    batch, prompt_len, gen, seed = 2, 32, 8, 0
    jcfg, cfg = _reduce(jax_get_arch, name), _reduce(get_arch, name)
    want, _, _ = jserve.serve_loop(jcfg, batch, prompt_len, gen, seed=seed)
    # the same weights and prompts as the reference's serve_loop draws them
    params = jtf.init_params(jcfg, jax.random.PRNGKey(seed))
    prompts = np.array(jax.random.randint(jax.random.PRNGKey(seed + 1), (batch, prompt_len),
                                          0, jcfg.vocab))
    got, t_p, t_d = serve_loop(cfg, batch, prompt_len, gen, seed=seed, device="cpu",
                               params=_np(params), prompts=prompts)
    assert got.shape == want.shape == (batch, gen) and got.dtype == np.int32
    assert t_p > 0 and t_d > 0
    # the reference's logits along its own tokens, and the port's, teacher-forced
    logits, cache = jtf.prefill(jcfg, params, jnp.asarray(prompts))
    cache = jax.tree.map(lambda c: jnp.pad(c, ((0, 0), (0, 0), (0, gen), (0, 0), (0, 0))), cache)
    ref = [np.asarray(logits)]
    for i in range(gen - 1):
        logits, cache = jtf.decode_step(jcfg, params, cache, jnp.asarray(want[:, i]),
                                        jnp.int32(prompt_len + i))
        ref.append(np.asarray(logits))
    model = TransformerLM(cfg, device="cpu")
    model.load_state_dict(lm_params_from_jax(cfg, _np(params)))
    lg, pc = model.prefill(torch.from_numpy(prompts), max_seq=prompt_len + gen)
    port = [lg.numpy()]
    for i in range(gen - 1):
        lg, pc = model.decode_step(pc, torch.from_numpy(want[:, i]), prompt_len + i)
        port.append(lg.numpy())
    for row in range(batch):
        clear = True  # no near-tie yet on this sequence: greedy must agree token for token
        for i in range(gen):
            top2 = np.sort(ref[i][row])[-2:]
            margin = (top2[1] - top2[0]) / np.abs(ref[i][row]).max()
            assert np.argmax(ref[i][row]) == want[row, i]
            if margin > TOL_LOGITS:
                assert np.argmax(port[i][row]) == want[row, i], (row, i)
            clear = clear and margin > TOL_LOGITS
            if clear:
                assert got[row, i] == want[row, i], (row, i)


# ----------------------------------------------------------------- launcher
def test_serve_lm_command_line_runs_on_the_cpu():
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_lm", "--arch", "granite-moe-1b-a400m",
         "--reduced", "--batch", "2", "--prompt-len", "16", "--gen", "4", "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=120, cwd=ROOT)
    assert run.returncode == 0, run.stderr
    assert "prefill" in run.stdout and "tok/s" in run.stdout
    assert "sample generations" in run.stdout
    alias = subprocess.run(
        [sys.executable, "-W", "always::DeprecationWarning", "-m", "repro_torch.launch.serve",
         "--arch", "gemma-7b", "--reduced", "--batch", "1", "--prompt-len", "8", "--gen", "2",
         "--device", "cpu"], capture_output=True, text=True, env=env, timeout=120, cwd=ROOT)
    assert alias.returncode == 0, alias.stderr
    assert "deprecated" in alias.stderr and "tok/s" in alias.stdout


def test_serve_loop_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a card")
    cfg = _reduce(get_arch, "gemma-7b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_loop(cfg, 1, 4, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_cell(_bundle(cfg, pre=("prefill", 4, 1)), "pre")

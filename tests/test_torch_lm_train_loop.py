"""The port's LM train cell, optimizer leaves, train state and launcher
against the JAX package, on the CPU.

Reduced archs as tests/test_arch_smoke.py reduces them
(``reduced_lm(layers=2, d_model=128, vocab=512)``), B = 2, S = 128 (a
127-token loss in one chunk; tests/test_torch_lm_train.py holds the
chunks and the tail).  Held against ``repro``:
- the train cell's ``static_meta`` of every LM arch's ``train_4k``,
  equal as floats, built on the meta device (nothing allocated);
- 3 train-cell steps against 3 jitted JAX ``train_step``s from the same
  state (AdamW, and Adafactor for llama4-maverick), the port on the
  reference's expert routes (tests/torch_lm_routes.py): each step's loss,
  CE and aux within ``TOL_LOSS`` (1e-2 relative); the first moments
  within ``TOL_GRAD`` (5 %) and the second moments (ν, Adafactor's vr /
  vc: squares of the gradients) within 2·``TOL_GRAD`` of their largest
  value; each parameter within one unit of its dtype plus 2·lr a step
  (each run moves an entry by about lr a step — AdamW's first updates
  are ±lr, Adafactor's RMS-clipped — and an entry whose gradient sits
  near zero may move the other way in the other run), and each
  parameter's update (the parameter less its start) against the
  reference's, by norms over the leaf: |Δport − Δref| within
  ``UPDATE_TOL_DIR`` (0.25) of |Δref| and |Δport| within
  ``UPDATE_TOL_NORM`` (5 %) of it (tests/torch_lm_routes.py: no update,
  the wrong sign or an lr 3× off fail it; at lr 1e-4 most bf16 weights
  do not move, so the bound on the parameters alone would pass them);
- Adafactor on the reference's stacked leaves: its state's shapes
  (``ln1``'s vr [L]) and one step on identical gradients with one
  expert's slice 100 times the others' (the update-RMS clip over a whole
  layer slice [E, d, 2ff]), rtol 1e-5 / atol 1e-7 (the same f32 formulas
  rounded in another order);
- checkpoints that either package writes and the other resumes (the
  train cell, and the launchers ``train_lm``).
Exact: the train state through ``train_state`` / ``load_train_state`` and
a ``Checkpointer``, and a resumed ``train_lm`` against an uninterrupted
one.
"""
import functools
import os
import subprocess
import sys
import tracemalloc
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.configs import base as jbase
from repro.configs import get_arch as jax_get_arch
from repro.configs.registry import ArchBundle as JaxArchBundle
from repro.launch import train as jtrain
from repro.launch.steps import _make_optimizer as jax_make_optimizer
from repro.launch.steps import build_cell as jax_build_cell
from repro.models import transformer as jtf
from repro_torch.checkpoint import CheckpointManager, Checkpointer
from repro_torch.configs import ArchBundle, LMShape, get_arch
from repro_torch.launch import train as ptrain
from repro_torch.launch.steps import build_cell, build_lm_cell, make_optimizer
from repro_torch.launch.train import reduced_lm, train_lm
from repro_torch.models import TransformerLM
from repro_torch.models.transformer import lm_loss
from torch_lm_routes import (UPDATE_TOL_DIR, UPDATE_TOL_NORM, jax_routes, leaves,
                             port_routes, update_gap)

LM_ARCHS = ["gemma-7b", "codeqwen1.5-7b", "deepseek-coder-33b", "granite-moe-1b-a400m",
            "llama4-maverick-400b-a17b"]
TOL_LOSS, TOL_GRAD = 1e-2, 5e-2
B, S = 2, 128
LR = 1e-4  # the train cells' (the reference's _make_optimizer default)
ROOT = Path(__file__).resolve().parents[1]


def _reduce(get, name):
    return (jtrain.reduced_lm if get is jax_get_arch else reduced_lm)(
        get(name).arch, layers=2, d_model=128, vocab=512)


def _np(tree):
    """A state of either package (dicts and NamedTuples of arrays or
    tensors) as nested dicts of numpy (bf16 as ml_dtypes' bfloat16)."""
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().copy().view(jnp.bfloat16)
        return t.numpy().copy()
    return np.asarray(tree)


def _f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32), np.float64)


def _tokens(step: int, vocab: int = 512) -> np.ndarray:
    return np.random.default_rng(step).integers(0, vocab, (B, S)).astype(np.int32)


def _bundles(jcfg, cfg):
    return (JaxArchBundle(jcfg, {"t": jbase.LMShape("t", "train", S, B)}),
            ArchBundle(cfg, {"t": LMShape("t", "train", S, B)}))


@functools.lru_cache(maxsize=None)
def _jax_cell(name):
    """(JAX cfg, port cfg, the jitted JAX train step, its start state)."""
    jcfg, cfg = _reduce(jax_get_arch, name), _reduce(get_arch, name)
    jcell = jax_build_cell(_bundles(jcfg, cfg)[0], "t")
    params = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    start = {"params": params, "opt": jax_make_optimizer(jcfg.optimizer).init(params)}
    return jcfg, cfg, jax.jit(jcell.fn), start


def _jax_step(name, state, tokens):
    jcfg, _, step, _ = _jax_cell(name)
    with jax_routes(jcfg) as routes:
        state, out = step(state, {"tokens": jnp.asarray(tokens)})
        jax.block_until_ready(state)
    return state, out, routes


def _port_cell(name, jstate=None, seed=0):
    _, cfg, _, start = _jax_cell(name)
    cell = build_lm_cell(_bundles(None, cfg)[1], "t", device="cpu", seed=seed)
    cell.load_train_state(_np(start if jstate is None else jstate))
    return cell


def _assert_states_close(got, want, start):
    """``got`` / ``want`` / ``start``: train states as numpy trees."""
    for key, value in leaves(want["params"]):
        base = _f64(dict(leaves(start["params"]))[key])
        mine = _f64(dict(leaves(got["params"]))[key])
        ref = _f64(value)
        unit = 2.0**-7 if value.dtype.name == "bfloat16" else 2.0**-22  # >= one unit
        bound = 2 * LR * int(want["opt"]["step"]) + unit * np.abs(ref)
        assert np.all(np.abs(mine - ref) <= bound), key
        gap_dir, gap_norm = update_gap(mine, ref, base)
        assert gap_dir <= UPDATE_TOL_DIR and abs(gap_norm) <= UPDATE_TOL_NORM, (
            key, gap_dir, gap_norm)
    assert int(got["opt"]["step"]) == int(want["opt"]["step"])
    for slot in want["opt"]:
        if slot == "step":
            continue
        tol = TOL_GRAD if slot == "mu" else 2 * TOL_GRAD
        for key, value in leaves(want["opt"][slot]):
            mine = _f64(dict(leaves(got["opt"][slot]))[key])
            ref = _f64(value)
            assert np.abs(mine - ref).max() <= tol * np.abs(ref).max(), (slot, key)


# ------------------------------------------------------------------ cells
@pytest.mark.parametrize("name", LM_ARCHS)
def test_lm_smoke_train_step(name):
    """tests/test_arch_smoke.py's train step, in the port: one step of
    ``make_optimizer(cfg.optimizer, lr=1e-3)`` on random tokens [2, 64]."""
    cfg = _reduce(get_arch, name)
    model = TransformerLM(cfg, device="cpu", generator=torch.Generator().manual_seed(0),
                          trainable=True)
    optimizer = make_optimizer(cfg.optimizer, model.parameters(), lr=1e-3)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    tokens = torch.randint(0, cfg.vocab, (2, 64), generator=torch.Generator().manual_seed(1),
                           dtype=torch.int32)
    loss, _ = lm_loss(model, tokens)
    loss.backward()
    optimizer.step()
    assert np.isfinite(float(loss.detach())) and float(loss.detach()) > 0
    delta = sum(float((p.detach().float() - before[n].float()).abs().sum())
                for n, p in model.named_parameters())
    assert delta > 0


@pytest.mark.parametrize("name", LM_ARCHS)
def test_train_cell_meta_matches_jax_without_allocating(name):
    want = jax_build_cell(jax_get_arch(name), "train_4k").static_meta
    tracemalloc.start()
    try:
        cell = build_cell(get_arch(name), "train_4k", device="meta")
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert peak < 1 << 20  # from the shapes: no parameter or state is made
    assert cell.fn is None and cell.model is None and cell.optimizer is None
    assert cell.static_meta == want
    assert {k: type(v) for k, v in cell.static_meta.items()} == {
        k: type(v) for k, v in want.items()}


@pytest.mark.parametrize("name", LM_ARCHS)
def test_three_train_cell_steps_match_three_jax_train_steps(name):
    jcfg, cfg, _, start = _jax_cell(name)
    cell = _port_cell(name)
    assert type(cell.optimizer).__name__ == ("Adafactor" if cfg.optimizer == "adafactor"
                                             else "AdamW")
    assert cell.optimizer.param_groups[0]["lr"] == LR
    jstate = start
    for step in range(3):
        tokens = _tokens(step)
        jstate, jout, routes = _jax_step(name, jstate, tokens)
        with port_routes(cell.model, routes or None):
            out = cell.fn({"tokens": tokens})
        assert sorted(out) == sorted(jout) == ["aux", "ce", "loss"]
        for key in out:
            got, want = float(out[key]), float(jout[key])
            assert abs(got - want) <= TOL_LOSS * abs(want), (step, key, got, want)
    assert all(p.grad is None for p in cell.model.parameters())  # set to None after a step
    _assert_states_close(_np(cell.train_state()), _np(jstate), _np(start))


def test_the_train_cell_refuses_a_frozen_model_and_bad_tokens():
    cfg = _reduce(get_arch, "gemma-7b")
    bundle = _bundles(None, cfg)[1]
    frozen = TransformerLM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="frozen"):
        build_lm_cell(bundle, "t", device="cpu", model=frozen)
    cell = build_lm_cell(bundle, "t", device="cpu")
    assert cell.model.trainable
    with pytest.raises(ValueError, match="tokens must be"):
        cell.fn({"tokens": np.zeros((B, S - 1), np.int32)})
    serve = build_lm_cell(ArchBundle(cfg, {"p": LMShape("p", "prefill", S, B)}), "p",
                          device="cpu", model=cell.model)  # a trainable model also serves
    logits, _ = serve.fn({"tokens": _tokens(0)})
    assert not logits.requires_grad
    with pytest.raises(ValueError, match="not a train cell"):
        serve.train_state()


# --------------------------------------------------------- the optimizer
def test_adafactor_steps_the_reference_stacked_leaves():
    """The state's shapes are the reference's (``ln1`` [L, d] factored into
    vr [L] and vc [d]; ``wi_e`` [L, E, d, 2ff] into [L, E, d] and [L, E,
    2ff]), and one step on identical gradients, one expert's slice 100
    times the rest, equals the reference's update: its RMS clip is taken
    over each layer's whole [E, d, 2ff] slice, not expert by expert."""
    name = "llama4-maverick-400b-a17b"
    jcfg, cfg, _, start = _jax_cell(name)
    cell = _port_cell(name)
    state = _np(cell.train_state())
    L, d, m = cfg.n_layers, cfg.d_model, cfg.moe
    assert state["opt"]["vr"]["layers"]["ln1"].shape == (L,)
    assert state["opt"]["vc"]["layers"]["ln1"].shape == (d,)
    assert state["opt"]["vr"]["layers"]["wi_e"].shape == (L, m.num_experts, d)
    assert state["opt"]["vc"]["layers"]["wi_e"].shape == (L, m.num_experts, 2 * m.d_ff)
    assert state["opt"]["vc"]["ln_f"].shape == (1,)
    want_specs = jax.tree.map(lambda x: x.shape, _np(start["opt"]))
    assert jax.tree.map(lambda x: x.shape, state["opt"]) == want_specs
    rng = np.random.default_rng(4)
    grads = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32),
                         _np(start["params"]))
    grads["layers"]["wi_e"][0, 3] *= 100.0
    jgrads = jax.tree.map(lambda g, p: jnp.asarray(g, p.dtype), grads, start["params"])
    jparams, jopt = joptim.adafactor(1e-4).update(jgrads, start["opt"], start["params"])
    views = cell.train_state()["params"]
    for key, p in leaves(views):
        p.grad = torch.from_numpy(dict(leaves(grads))[key]).to(p.dtype)
    cell.optimizer.step()
    got = _np(cell.train_state())
    for key, value in leaves(_np(jparams)):
        np.testing.assert_allclose(_f64(dict(leaves(got["params"]))[key]), _f64(value),
                                   rtol=1e-5, atol=1e-7, err_msg=key)
    for slot in ("vr", "vc"):
        for key, value in leaves(_np(jopt._asdict()[slot])):
            np.testing.assert_allclose(dict(leaves(got["opt"][slot]))[key], value,
                                       rtol=1e-5, atol=1e-7, err_msg=(slot, key))


# ------------------------------------------------------------- train state
@pytest.mark.parametrize("name", ["granite-moe-1b-a400m", "llama4-maverick-400b-a17b"])
def test_train_state_round_trip_is_bitwise(name, tmp_path):
    cell = _port_cell(name)
    cell.fn({"tokens": _tokens(0)})
    want = _np(cell.train_state())
    other = _port_cell(name, seed=5)
    other.load_train_state(want)
    got = _np(other.train_state())
    assert int(got["opt"]["step"]) == int(want["opt"]["step"]) == 1
    for (k, a), (_, b) in zip(leaves(got), leaves(want)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k
    ck = Checkpointer(str(tmp_path))
    ck.save(1, cell.train_state(), {"stream_step": 2})
    third = _port_cell(name, seed=6)
    restored, meta = ck.restore(third.train_state())
    third.load_train_state(restored)
    assert meta == {"stream_step": 2}
    for (k, a), (_, b) in zip(leaves(_np(third.train_state())), leaves(want)):
        assert a.tobytes() == b.tobytes(), k
    # the state is the live tensors: no copy of the model is made
    assert cell.train_state()["params"]["layers"]["wq"] is cell.model.layers.wq


@pytest.mark.parametrize("name", ["granite-moe-1b-a400m", "llama4-maverick-400b-a17b"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_a_checkpoint_of_either_package_resumes_in_the_other(tmp_path, name, direction):
    """Two steps and a save in one package, a restore and step 3 in the
    other: close to step 3 of a straight JAX run (the same next step)."""
    jcfg, cfg, _, start = _jax_cell(name)
    straight, routes = start, []
    for step in range(3):
        straight, _, r = _jax_step(name, straight, _tokens(step))
        routes.append(r or None)
    root = str(tmp_path / "ck")
    if direction == "jax_to_port":
        jstate = start
        for step in range(2):
            jstate, _, _ = _jax_step(name, jstate, _tokens(step))
        assert JaxCheckpointManager(root, save_every=1).maybe_save(1, jstate, {"stream_step": 2})
        cell = _port_cell(name, seed=3)
        state, meta, begin = CheckpointManager(root).restore_or_init(cell.train_state())
        cell.load_train_state(state)
        assert begin == 2 and meta == {"stream_step": 2}
        assert int(cell.train_state()["opt"]["step"]) == 2
        with port_routes(cell.model, routes[2]):
            cell.fn({"tokens": _tokens(begin)})
        _assert_states_close(_np(cell.train_state()), _np(straight), _np(start))
    else:
        cell = _port_cell(name)
        for step in range(2):
            with port_routes(cell.model, routes[step]):
                cell.fn({"tokens": _tokens(step)})
        mgr = CheckpointManager(root, save_every=1, async_writes=True)
        assert mgr.maybe_save(1, cell.train_state(), {"stream_step": 2})
        mgr.ckpt.close()
        state, meta, begin = JaxCheckpointManager(root).restore_or_init(start)
        assert begin == 2 and meta == {"stream_step": 2} and int(state["opt"].step) == 2
        state, _, _ = _jax_step(name, state, _tokens(begin))
        _assert_states_close(_np(state), _np(straight), _np(start))


# -------------------------------------------------------------- launcher
def test_train_lm_loss_falls_and_a_resumed_run_equals_the_straight_one(tmp_path):
    cfg = _reduce(get_arch, "granite-moe-1b-a400m")
    kw = dict(batch=2, seq=64, log_every=100, device="cpu")
    straight = train_lm(cfg, 10, **kw)
    losses = straight["losses"]
    assert len(losses) == 10 and all(np.isfinite(losses))
    assert np.mean(losses[-3:]) < np.mean(losses[:3])
    root = str(tmp_path / "ck")
    first = train_lm(cfg, 6, ckpt_dir=root, save_every=2, **kw)  # saves at steps 0, 2, 4
    assert first["losses"] == losses[:6]
    rest = train_lm(cfg, 10, ckpt_dir=root, save_every=2, **kw)  # resumes after step 4
    assert rest["losses"] == losses[5:]
    for (k, a), (_, b) in zip(leaves(_np(rest["state"])), leaves(_np(straight["state"]))):
        assert a.tobytes() == b.tobytes(), k


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_train_lm_resumes_the_other_packages_checkpoint(tmp_path, capsys, direction):
    """The launchers: 3 steps (saving every step) in one package, then the
    other resumes the directory after step 2 and runs steps 3 and 4, whose
    losses are those of the first package's uninterrupted run (a dense
    arch: no route to hold)."""
    jcfg, cfg = _reduce(jax_get_arch, "gemma-7b"), _reduce(get_arch, "gemma-7b")
    kw = dict(batch=2, seq=64, log_every=100)
    root = str(tmp_path / "ck")
    if direction == "jax_to_port":
        want = jtrain.train_lm(jcfg, 5, **kw)["losses"]
        jtrain.train_lm(jcfg, 3, ckpt_dir=root, save_every=1, **kw)
        got = train_lm(cfg, 5, ckpt_dir=root, save_every=1, device="cpu", **kw)["losses"]
    else:
        want = train_lm(cfg, 5, device="cpu", **kw)["losses"]
        train_lm(cfg, 3, ckpt_dir=root, save_every=1, device="cpu", **kw)
        got = jtrain.train_lm(jcfg, 5, ckpt_dir=root, save_every=1, **kw)["losses"]
    assert "resumed from step 3" in capsys.readouterr().out
    assert len(got) == 2
    np.testing.assert_allclose(got, want[3:], rtol=TOL_LOSS)


def test_train_main_runs_on_the_cpu_and_resumes(tmp_path):
    args = ["--arch", "granite-moe-1b-a400m", "--steps", "3", "--batch", "2", "--seq", "64",
            "--layers", "2", "--d-model", "128", "--vocab", "512", "--device", "cpu",
            "--ckpt-dir", str(tmp_path / "ck")]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train"]
    run = subprocess.run(cmd + args, capture_output=True, text=True, env=env, timeout=300)
    assert run.returncode == 0, run.stderr
    assert "step     0 loss" in run.stdout and "final loss:" in run.stdout
    args[args.index("--steps") + 1] = "4"
    run = subprocess.run(cmd + args, capture_output=True, text=True, env=env, timeout=300)
    assert run.returncode == 0, run.stderr
    assert "resumed from step 1" in run.stdout  # step 0 was saved (every 50 steps)


def test_train_main_needs_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ptrain.main(["--arch", "gemma-7b", "--steps", "1", "--layers", "1", "--d-model", "128",
                     "--vocab", "256", "--seq", "16", "--batch", "1"])
    with pytest.raises(SystemExit, match="LM archs"):
        ptrain.main(["--arch", "dlrm-rm2", "--device", "cpu"])


def test_train_example_keeps_no_checkpoint_unless_asked(tmp_path):
    """examples/train_lm_torch.py without --ckpt-dir writes nothing and
    resumes nothing: a second run starts from step 0 again."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), TMPDIR=str(tmp_path),
               HOME=str(tmp_path))
    cmd = [sys.executable, str(ROOT / "examples" / "train_lm_torch.py"), "--tiny", "--device",
           "cpu", "--steps", "2"]
    outs = []
    for _ in range(2):
        run = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=tmp_path,
                             timeout=300)
        assert run.returncode == 0, run.stderr
        outs.append(run.stdout)
    assert all("step     0 loss" in out and "resumed" not in out for out in outs)
    assert all("(final)" in out for out in outs)
    assert not [f for f in tmp_path.rglob("*") if f.is_file()]  # (torch may make empty dirs)

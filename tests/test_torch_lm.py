"""The port's LM building blocks against the JAX package, on the CPU.

``rms_norm``, ``rope`` (its frequencies bit for bit, positions up to
524 287), the two gated activations, ``causal_attention`` (several
q-chunks, one chunk, a ragged length, a sliding window), ``decode_attention``
(several positions, with and without a window, B below and above the kv
heads) and ``moe_ffn`` (no drop, and drops forced by a small capacity
factor) take the same numpy inputs (seeded) through both packages.

Tolerances, each a bound on max |port − JAX|:
- f32 results: rtol 1e-6 (rms_norm) or 1e-5 (rope, activations) plus
  atol of the same size;
- bf16 results: a number of units in the last place of the largest
  |JAX| value (bf16 keeps 8 significant bits: an ulp of x is
  2^(floor(log2 |x|) − 7)): 1 for the norm, rope and attention,
  ``BF16_ULPS`` for the activations, ``MOE_ULPS`` for the MoE.  XLA on
  the CPU computes a bf16 ``logistic`` as exp, add and divide, each
  rounded to bf16; torch rounds the f32 result once, so the activations
  differ by a unit or two, and the expert's second product and the k-row
  combine carry that on;
- the MoE's routing: expert ids and slots equal as integers, the drop
  counts equal; the aux loss rtol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro_torch.models import attention, layers, moe

BF16_ULPS, MOE_ULPS = 2, 4


def _bf16_close(got: torch.Tensor, want, ulps: float = BF16_ULPS) -> float:
    """max |got − want| in ulps of the largest |want| (asserted <= ulps)."""
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    err = float(np.abs(got - want).max()) / ulp
    assert err <= ulps, err
    return err


def _pair(arr: np.ndarray, dtype: str):
    """(jnp, torch) copies of ``arr`` in ``dtype`` ("f32" or "bf16"), the
    same bits."""
    j = jnp.asarray(arr, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    t = torch.from_numpy(np.asarray(j.astype(jnp.float32)))
    return j, (t.bfloat16() if dtype == "bf16" else t)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rms_norm_matches_jax(dtype):
    rng = np.random.default_rng(0)
    jx, tx = _pair(3.0 * rng.standard_normal((4, 7, 256)), dtype)
    scale = rng.standard_normal(256).astype(np.float32) * 0.1
    want = jlayers.rms_norm(jx, jnp.asarray(scale))
    got = layers.rms_norm(tx, torch.from_numpy(scale))
    assert got.dtype == tx.dtype
    if dtype == "f32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    else:
        _bf16_close(got, want, ulps=1.0)


@pytest.mark.parametrize("head_dim", [64, 128, 256])
@pytest.mark.parametrize("theta", [1e4, 5e5])
def test_rope_frequencies_are_bit_equal(head_dim, theta):
    half = head_dim // 2
    want = np.asarray(theta ** (-jnp.arange(0, half, dtype=jnp.float32) / half))
    got = layers.rope_frequencies(head_dim, theta).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("head_dim", [64, 256])
def test_rope_matches_jax_up_to_position_524287(dtype, head_dim):
    rng = np.random.default_rng(head_dim)
    jx, tx = _pair(rng.standard_normal((2, 6, 3, head_dim)), dtype)
    pos = np.array([[0, 1, 2, 511, 4095, 32767], [524282, 524283, 524284, 524285, 524286,
                                                     524287]], np.int32)
    want = jlayers.rope(jx, jnp.asarray(pos))
    got = layers.rope(tx, torch.from_numpy(pos))
    if dtype == "f32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    else:
        _bf16_close(got, want, ulps=1.0)


@pytest.mark.parametrize("name", ["silu", "gelu"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_activations_match_jax(name, dtype):
    rng = np.random.default_rng(1)
    jx, tx = _pair(3.0 * rng.standard_normal((64, 2 * 96)), dtype)
    want = jlayers.ACTIVATIONS[name](jx)
    got = layers.ACTIVATIONS[name](tx)
    assert tuple(got.shape) == (64, 96)
    if dtype == "f32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    else:
        _bf16_close(got, want)


def _qkv(b, s, h, kh, hd, seed):
    rng = np.random.default_rng(seed)
    return [_pair(rng.standard_normal((b, s, n, hd)), "bf16") for n in (h, kh, kh)]


@pytest.mark.parametrize("s,q_chunk,window,hd", [
    (256, 64, None, 64),   # four q-chunks
    (256, 512, None, 64),  # one chunk (q_chunk > S)
    (96, 64, None, 128),   # ragged: one chunk of 96, a scale that is not a power of 2
    (256, 64, 48, 64),     # sliding window across the chunks
    (128, 32, None, 256),  # gemma's head_dim
])
def test_causal_attention_matches_jax(s, q_chunk, window, hd):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(2, s, 4, 2, hd, s + hd)
    want = jattn.causal_attention(jq, jk, jv, q_chunk=q_chunk, window=window)
    got = attention.causal_attention(tq, tk, tv, q_chunk=q_chunk, window=window)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (2, s, 4, hd)
    _bf16_close(got, want, ulps=1.0)


@pytest.mark.parametrize("b,kh", [(1, 2), (3, 2), (4, 1)])  # B <= K: a product a sequence
@pytest.mark.parametrize("pos", [0, 37, 127])
@pytest.mark.parametrize("window", [None, 16])
def test_decode_attention_matches_jax(b, kh, pos, window):
    rng = np.random.default_rng(pos + b)
    jq, tq = _pair(rng.standard_normal((b, 4, 64)), "bf16")
    (jk, tk), (jv, tv) = [_pair(rng.standard_normal((b, 128, kh, 64)), "bf16") for _ in "kv"]
    want = jattn.decode_attention(jq, jk, jv, jnp.int32(pos), window=window)
    got = attention.decode_attention(tq, tk, tv, pos, window=window)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (b, 4, 64)
    _bf16_close(got, want, ulps=1.0)


def test_bmm_f32_accumulates_bf16_operands_in_f32():
    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.standard_normal((3, 5, 64)).astype(np.float32)).bfloat16()
    b = torch.from_numpy(rng.standard_normal((3, 64, 7)).astype(np.float32)).bfloat16()
    got = attention.bmm_f32(a, b)
    assert got.dtype == torch.float32
    want = np.einsum("nmk,nkp->nmp", a.double().numpy(), b.double().numpy())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _jax_routing(x, router_w, top_k, cf):
    """The reference's routing steps (models/moe.py of the JAX package,
    its lines for the top-k, the rank within the expert and the capacity):
    (expert ids [T, k], slots [T·k], capacity)."""
    t, e = x.shape[0], router_w.shape[1]
    probs = jax.nn.softmax(x.astype(jnp.float32) @ router_w.astype(jnp.float32), axis=-1)
    _, expert_ids = jax.lax.top_k(probs, top_k)
    flat_e = expert_ids.reshape(-1)
    onehot = jax.nn.one_hot(flat_e, e, dtype=jnp.int32)
    ranks_all = jnp.cumsum(onehot, axis=0) - onehot
    pos = jnp.take_along_axis(ranks_all, flat_e[:, None], axis=1)[:, 0]
    cap = max(8, int(cf * t * top_k / e))
    cap += (-cap) % 8
    return np.asarray(expert_ids), np.asarray(pos), cap


@pytest.mark.parametrize("activation", ["silu", "gelu"])
@pytest.mark.parametrize("top_k,cf,drops", [
    (2, 4.0, False),  # cap >= T: no expert can overflow
    (8, 1.0, False),  # k = E: every expert takes every token, cap = T
    (2, 1.25, True),  # the published capacity factor overflows at this T
    (2, 0.3, True),   # forced drops
    (1, 0.5, True),   # top-1 (llama4's k): a dropped token comes out zero
])
def test_moe_ffn_matches_jax(activation, top_k, cf, drops):
    rng = np.random.default_rng(top_k)
    t, d, e, ff = 96, 128, 8, 256
    jx, tx = _pair(rng.standard_normal((t, d)), "bf16")
    router = (rng.standard_normal((d, e)) * d**-0.5).astype(np.float32)
    (jwi, twi), (jwo, two) = _pair(rng.standard_normal((e, d, 2 * ff)) * d**-0.5, "bf16"), \
        _pair(rng.standard_normal((e, ff, d)) * ff**-0.5, "bf16")
    ids_j, pos_j, cap_j = _jax_routing(jx, jnp.asarray(router), top_k, cf)
    _, _, ids = moe.route(tx, torch.from_numpy(router), top_k)
    pos = moe.expert_slots(ids.reshape(-1), e)
    np.testing.assert_array_equal(ids.numpy(), ids_j)
    np.testing.assert_array_equal(pos.numpy(), pos_j)
    assert moe.capacity(t, top_k, e, cf) == cap_j
    assert bool((pos_j >= cap_j).any()) == drops

    want, aux_j = jmoe.moe_ffn(jx, jnp.asarray(router), jwi, jwo, top_k=top_k,
                               capacity_factor=cf, activation=activation)
    got, aux = moe.moe_ffn(tx, torch.from_numpy(router), twi, two, top_k=top_k,
                           capacity_factor=cf, activation=activation)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (t, d)
    _bf16_close(got, want, ulps=MOE_ULPS)
    np.testing.assert_allclose(float(aux), float(aux_j), rtol=1e-6)
    if drops:  # a token all of whose assignments dropped comes out zero in both
        gone = (pos_j >= cap_j).reshape(t, top_k).all(axis=1)
        assert gone.any() or cf >= 1
        assert not got[torch.from_numpy(gone)].any()


"""Helpers of the LM training comparisons (tests/test_torch_lm_train*.py,
tests/test_torch_gpu.py and chip_smoke.py's phase 18): expert routes
held equal across two runs, and an optimizer step's update held against
another's.

A route is a discontinuous function of its input: where a token's top-k
sits at a near-tie, a bf16 unit of drift upstream sends it to another
expert, and with top-1 that moves the whole gradient.  So those tests
capture the reference's own expert ids from its jitted program
(:func:`jax_routes`) and run the port on them (:func:`port_routes`);
the card is held to the CPU's routes the same way.

At the train cells' lr of 1e-4 a parameter moves by about lr a step, and
most bf16 weights not at all, so a bound on the parameters themselves
cannot tell a right update from none, from one of the wrong sign or from
one at another lr.  :func:`update_gap` compares the updates (the
parameters less their start) leaf by leaf instead.

This module imports JAX only inside :func:`jax_routes`.
"""
import contextlib

import numpy as np
import torch

from repro_torch.models import moe


_SINKS: list[list] = []  # the capture in progress, innermost last
_REAL: list = []  # JAX's own top_k, looked up once


def _record(ids) -> None:
    if _SINKS:
        _SINKS[-1].append(np.asarray(ids))


def _top_k(x, k):
    import jax

    vals, idx = _REAL[0](x, k)
    jax.debug.callback(_record, idx)
    return vals, idx


@contextlib.contextmanager
def jax_routes(jcfg):
    """Capture the reference's expert ids of every MoE layer as its jitted
    program computes them (its MoE's ``jax.lax.top_k``, wrapped while the
    block runs: a program traced in such a block keeps the wrapper's
    callback and reports to the capture in progress when it runs again).
    Yields a list that holds, once the block ends, the forward's ids of
    layer 0 … L − 1 (empty for a dense arch); the remat backward's
    recomputed ids must equal them."""
    import jax

    if not _REAL:
        _REAL.append(jax.lax.top_k)
    seen, ids, real = [], [], jax.lax.top_k
    _SINKS.append(seen)
    jax.lax.top_k = _top_k
    try:
        yield ids
        jax.effects_barrier()
    finally:
        jax.lax.top_k = real
        _SINKS.pop()
    n = jcfg.n_layers
    if jcfg.moe is None:
        assert not seen
        return
    assert len(seen) in (n, 2 * n), len(seen)
    for a, b in zip(seen[:n], seen[n:][::-1]):  # the recompute runs backwards
        np.testing.assert_array_equal(a, b)
    ids.extend(seen[:n])


@contextlib.contextmanager
def port_routes(model, pinned=None):
    """Within the block the port's MoE layers route to ``pinned`` (a list
    of per-layer expert ids, the gates then the router's probabilities at
    those ids, renormalised, as ``moe.route`` gives them); without, their
    own routes are recorded.  Yields the per-layer ids used."""
    real, used = moe.route, {}

    def route(x, router_w, top_k):
        layer = ((router_w.data_ptr() - model.layers.router.data_ptr())
                 // (router_w.numel() * router_w.element_size()))
        probs, gates, ids = real(x, router_w, top_k)
        if pinned is not None:
            ids = torch.tensor(pinned[layer], dtype=torch.long, device=x.device)
            gates = probs.gather(-1, ids)
            gates = gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)
        used.setdefault(layer, ids.detach().cpu().numpy())
        return probs, gates, ids

    moe.route = route
    out = []
    try:
        yield out
    finally:
        moe.route = real
    out.extend(used[l] for l in sorted(used))


# update_gap's bounds: the direction within UPDATE_TOL_DIR, the norm within UPDATE_TOL_NORM.
# Three steps of a reduced arch, the port against the JAX package, stay within 0.14 and 0.006
# on every leaf (entries whose gradient sits near zero move the other way, and a bf16 entry
# near a rounding boundary by one unit more or less); no update is 1 and 1, the wrong sign 2
# and 0, an lr 3x off 2 and 2.
UPDATE_TOL_DIR, UPDATE_TOL_NORM = 0.25, 0.05


def leaves(tree, prefix: str = "") -> list:
    """(key path joined with /, leaf) pairs of a nested dict."""
    if isinstance(tree, dict):
        return [kv for k, v in tree.items() for kv in leaves(v, f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def update_gap(mine, ref, start) -> tuple[float, float]:
    """(|Δmine − Δref| / |Δref|, |Δmine| / |Δref| − 1), the Frobenius norms of
    the updates Δ = x − start of one leaf (float64 numpy arrays); the
    reference must have moved it."""
    d_mine, d_ref = mine - start, ref - start
    norm = float(np.linalg.norm(d_ref))
    assert norm > 0.0, "the reference did not move the leaf"
    return (float(np.linalg.norm(d_mine - d_ref)) / norm,
            float(np.linalg.norm(d_mine)) / norm - 1.0)

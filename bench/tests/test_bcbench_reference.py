"""The benchmark's plain reference against a brute-force count of shortest
paths, and its R-MAT draw and plan checks (CPU, small graphs)."""
from __future__ import annotations

import itertools
import sys
from collections import deque
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bcbench import reference, rmat  # noqa: E402


def _arcs(n: int, edges) -> tuple[np.ndarray, np.ndarray]:
    pairs = {(min(u, v), max(u, v)) for u, v in edges if u != v}
    arcs = sorted([(u, v) for u, v in pairs] + [(v, u) for u, v in pairs])
    a = np.array(arcs, dtype=np.int32).reshape(-1, 2)
    return a[:, 0].copy(), a[:, 1].copy()


def _bfs(adj, s):
    dist, sigma = {s: 0}, {s: 1}
    q = deque([s])
    while q:
        u = q.popleft()
        for w in adj[u]:
            if w not in dist:
                dist[w], sigma[w] = dist[u] + 1, 0
                q.append(w)
            if dist[w] == dist[u] + 1:
                sigma[w] += sigma[u]
    return dist, sigma


def brute_bc(n, src, dst) -> np.ndarray:
    """BC by counting: for every ordered pair (s, t), the share of the
    shortest s-t paths through v, from the path counts σ_sv σ_vt / σ_st."""
    adj = [[] for _ in range(n)]
    for u, v in zip(src.tolist(), dst.tolist()):
        adj[u].append(v)
    info = [_bfs(adj, s) for s in range(n)]
    bc = np.zeros(n)
    for s, t in itertools.permutations(range(n), 2):
        ds, ss = info[s]
        if t not in ds:
            continue
        dt, st = info[t]
        for v in range(n):
            if v in (s, t) or v not in ds or v not in dt:
                continue
            if ds[v] + dt[v] == ds[t]:
                bc[v] += ss[v] * st[v] / ss[t]
    return bc


def _random_graph(n, m, seed):
    rng = np.random.default_rng(seed)
    return _arcs(n, rng.integers(0, n, size=(m, 2)).tolist())


def _all_columns(dec, brandes):
    roots = np.nonzero(dec.eligible)[0]
    total = torch.zeros(dec.n, dtype=torch.float64)
    sizes = {}
    for chunk in np.array_split(roots, max(1, roots.size // 7)):
        out = brandes.round(chunk)
        total += out.bc
        sizes.update(zip(chunk.tolist(), out.ns.tolist()))
    return total.numpy(), sizes


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reference_matches_brute_force_without_leaves(seed):
    # a cycle with chords has no vertex of degree 1: ω = 0, residual = graph
    n = 14
    rng = np.random.default_rng(seed)
    edges = [(i, (i + 1) % n) for i in range(n)] + rng.integers(0, n, size=(6, 2)).tolist()
    src, dst = _arcs(n, edges)
    dec = reference.decompose(n, src, dst)
    assert not dec.omega.any() and dec.eligible.all()
    bc, _ = _all_columns(dec, reference.Brandes(dec, torch.device("cpu")))
    np.testing.assert_allclose(bc, brute_bc(n, src, dst), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("seed", [3, 4, 5, 6])
def test_reference_with_leaves_matches_brute_force_where_no_leaf_hangs(seed):
    # on a residual vertex with no removed leaf the 1-degree corrections
    # add nothing, so the ω-weighted sweep alone is its exact BC; every
    # root's n_s is its component's size in the input graph
    n = 18
    src, dst = _random_graph(n, 24, seed)
    dec = reference.decompose(n, src, dst)
    bc, sizes = _all_columns(dec, reference.Brandes(dec, torch.device("cpu")))
    brute = brute_bc(n, src, dst)
    plain = dec.eligible & (dec.omega == 0)
    assert plain.any()
    np.testing.assert_allclose(bc[plain], brute[plain], rtol=1e-12, atol=1e-12)
    adj = [[] for _ in range(n)]
    for u, v in zip(src.tolist(), dst.tolist()):
        adj[u].append(v)
    for root, ns in sizes.items():
        assert ns == len(_bfs(adj, root)[0])


@pytest.mark.parametrize("seed", [3, 4, 5, 6])
def test_unreduced_reference_matches_brute_force_everywhere(seed):
    # without the 1-degree reduction (h0, h2) every arc stays and ω = 0, so
    # the sweep over every vertex of degree >= 1 is the exact BC of every
    # vertex, leaves included
    n = 18
    src, dst = _random_graph(n, 24, seed)
    dec = reference.decompose(n, src, dst, reduce=False)
    assert not dec.omega.any() and dec.residual_arcs == src.size
    deg = np.bincount(src, minlength=n)
    assert np.array_equal(dec.eligible, deg >= 1) and (deg == 1).any()
    bc, sizes = _all_columns(dec, reference.Brandes(dec, torch.device("cpu")))
    np.testing.assert_allclose(bc, brute_bc(n, src, dst), rtol=1e-12, atol=1e-12)
    adj = [[] for _ in range(n)]
    for u, v in zip(src.tolist(), dst.tolist()):
        adj[u].append(v)
    for root, ns in sizes.items():
        assert ns == len(_bfs(adj, root)[0])


def test_sample_roots_are_a_sorted_seeded_subset():
    eligible = np.arange(3, 400, 3)
    roots = reference.sample_roots(eligible, 20, 2**31 + 5)
    assert roots.size == 20 and np.all(np.diff(roots) > 0) and np.isin(roots, eligible).all()
    assert np.array_equal(roots, reference.sample_roots(eligible, 20, 2**31 + 5))
    assert not np.array_equal(roots, reference.sample_roots(eligible, 20, 2**31 + 6))
    assert np.array_equal(reference.sample_roots(eligible, eligible.size, 1), eligible)


def test_bfloat16_control_departs_from_the_reference():
    n, src, dst = rmat.rmat_arcs(10, 16, seed=1)
    dec = reference.decompose(n, src, dst)
    roots = np.nonzero(dec.eligible)[0][:32]
    exact = reference.Brandes(dec, torch.device("cpu")).round(roots)
    low = reference.Brandes(dec, torch.device("cpu"), torch.bfloat16).round(roots)
    rel = (low.bc.double() - exact.bc).abs() / exact.bc.abs().clamp(min=1.0)
    assert float(rel.max()) > 1e-3
    assert (low.ns != exact.ns).any()


def test_rmat_draw_is_a_sorted_symmetric_simple_arc_list():
    n, src, dst = rmat.rmat_arcs(9, 8, seed=3)
    assert n == 512 and src.dtype == np.int32 and dst.dtype == np.int32
    key = src.astype(np.int64) * n + dst
    assert np.all(np.diff(key) > 0)  # sorted, no duplicate
    assert not np.any(src == dst)
    rev = np.sort(dst.astype(np.int64) * n + src)
    assert np.array_equal(rev, key)  # symmetric
    again = rmat.rmat_arcs(9, 8, seed=3)
    assert np.array_equal(again[1], src) and np.array_equal(again[2], dst)


def test_graph_cache_round_trips_and_holds_one_graph(tmp_path, monkeypatch):
    monkeypatch.setattr(rmat, "CACHE_MIN_DRAWS", 1)
    spec = {"scale": 8, "edge_factor": 4, "seed": 5, "a": 0.57, "b": 0.19, "c": 0.19}
    made = rmat.load_or_make(spec, tmp_path)
    loaded = rmat.load_or_make(spec, tmp_path)
    assert made[0] == loaded[0]
    assert np.array_equal(made[1], loaded[1]) and np.array_equal(made[2], loaded[2])
    rmat.load_or_make(dict(spec, seed=6), tmp_path)
    assert len(list(tmp_path.iterdir())) == 1


def test_plan_checks_catch_a_missing_root_and_a_wrong_triple():
    # a path 0-1-2-3-4 closed by 4-0: every vertex has degree 2
    n = 5
    src, dst = _arcs(n, [(0, 1), (1, 2), (2, 3), (3, 4), (4, 0)])
    dec = reference.decompose(n, src, dst)
    every = np.flatnonzero(dec.eligible)
    assert reference.coverage_errors(dec, np.arange(n), every) == 0
    assert reference.coverage_errors(dec, np.array([0, 1, 2, 3]), every) == 1
    assert reference.coverage_errors(dec, np.array([0, 1, 2, 3, 4, 4]), every) == 1
    # a sample: exactly the roots wanted, each once
    want = np.array([1, 3])
    assert reference.coverage_errors(dec, np.array([1, 3]), want) == 0
    assert reference.coverage_errors(dec, np.array([1, 2]), want) == 2
    assert reference.coverage_errors(dec, np.array([1, 3, 3]), want) == 1
    assert reference.coverage_errors(dec, np.arange(n), want) == 3
    sources = np.array([0, 2, -1], np.int32)
    good = np.array([[1, 0, 1], [-1, -1, -1]], np.int32)
    bad = np.array([[3, 0, 1], [-1, -1, -1]], np.int32)
    assert reference.check_round(dec, sources, good) == 0
    assert reference.check_round(dec, sources, bad) == 1

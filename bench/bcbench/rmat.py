"""The benchmark's frozen R-MAT generator and its graph cache (numpy).

A copy of the draw the port's ``rmat_graph`` makes (Chakrabarti et al.'s
R-MAT, the Graph500 / paper §4.1 parameters a = 0.57, b = c = 0.19):
``edge_factor · 2^scale`` edge draws, one quadrant per bit from
``numpy.random.default_rng(seed)``, the vertex ids permuted, self loops
and duplicate pairs dropped, the rest symmetrised into a sorted arc list.
It is kept here so that the yardstick's graph does not move when the
program's generator does.

Large graphs are cached inside the checkout as CSR arrays
(``row_ptr`` int64 [n + 1], ``col`` int32 [arcs]) under a fixed
directory, one graph at a time: a later run loads in a second or two
what takes a minute to draw.
"""
from __future__ import annotations

import shutil
from pathlib import Path

import numpy as np

__all__ = ["rmat_arcs", "load_or_make", "CACHE_MIN_DRAWS"]

#: graphs of at least this many edge draws are cached (scale 20 at EF 16)
CACHE_MIN_DRAWS = 1 << 24


def _rmat_ids(rng: np.random.Generator, scale: int, m: int, a: float, b: float,
              c: float) -> tuple[np.ndarray, np.ndarray]:
    """(src, dst) of ``m`` R-MAT draws over 2**scale ids, before the
    permutation: per bit one uniform draw r, quadrant q = [r ≥ a] +
    [r ≥ a + b] + [r ≥ a + b + c]; the source bit is q ≥ 2, the
    destination bit q odd."""
    src = np.zeros(m, dtype=np.uint32)
    dst = np.zeros(m, dtype=np.uint32)
    r = np.empty(m)
    q = np.empty(m, dtype=np.uint8)
    hit = np.empty(m, dtype=np.bool_)
    bits = np.empty(m, dtype=np.uint32)
    for bit in range(scale):
        rng.random(out=r)
        np.greater_equal(r, a, out=hit)
        q[:] = hit
        for threshold in (a + b, a + b + c):
            np.greater_equal(r, threshold, out=hit)
            q += hit
        np.right_shift(q, 1, out=bits)
        bits <<= np.uint32(bit)
        src |= bits
        np.bitwise_and(q, 1, out=bits)
        bits <<= np.uint32(bit)
        dst |= bits
    return src, dst


def rmat_arcs(scale: int, edge_factor: int, seed: int, a: float = 0.57, b: float = 0.19,
              c: float = 0.19) -> tuple[int, np.ndarray, np.ndarray]:
    """(n, src int32 [arcs], dst int32 [arcs]): the symmetric arc list of
    the R-MAT graph, sorted by (src, dst), each undirected edge twice."""
    if not 1 <= scale <= 31:
        raise ValueError(f"scale must be in 1..31, got {scale}")
    n = 1 << scale
    rng = np.random.default_rng(seed)
    u, v = _rmat_ids(rng, scale, edge_factor * n, a, b, c)
    perm = rng.permutation(n)
    u = perm[u]
    v = perm[v]
    keep = u != v
    lo = np.minimum(u[keep], v[keep])
    hi = np.maximum(u[keep], v[keep])
    del u, v, keep
    key = lo * n + hi
    del lo, hi
    key.sort()
    first = np.ones(key.size, dtype=bool)
    np.not_equal(key[1:], key[:-1], out=first[1:])
    key = key[first]
    del first
    lo, hi = np.divmod(key, n)
    arcs = np.concatenate([key, hi * n + lo])
    del key, lo, hi
    arcs.sort()
    src, dst = np.divmod(arcs, n)
    return n, src.astype(np.int32), dst.astype(np.int32)


def _key(spec: dict) -> str:
    return (f"rmat-s{spec['scale']}-ef{spec['edge_factor']}-seed{spec['seed']}"
            f"-a{spec['a']}-b{spec['b']}-c{spec['c']}")


def load_or_make(spec: dict, cache_dir: Path | None) -> tuple[int, np.ndarray, np.ndarray]:
    """The graph of ``spec`` (keys scale, edge_factor, seed, a, b, c) as
    :func:`rmat_arcs` gives it: drawn, or loaded from ``cache_dir`` when a
    run of this checkout drew it before.  A graph of at least
    :data:`CACHE_MIN_DRAWS` draws is written there, replacing any other."""
    args = (spec["scale"], spec["edge_factor"], spec["seed"], spec["a"], spec["b"], spec["c"])
    big = spec["edge_factor"] << spec["scale"] >= CACHE_MIN_DRAWS
    if cache_dir is None or not big:
        return rmat_arcs(*args)
    entry = cache_dir / _key(spec)
    if (entry / "done").is_file():
        row_ptr = np.load(entry / "row_ptr.npy")
        col = np.load(entry / "col.npy")
        n = row_ptr.size - 1
        src = np.repeat(np.arange(n, dtype=np.int32), np.diff(row_ptr))
        return n, src, col
    n, src, dst = rmat_arcs(*args)
    if cache_dir.exists():
        shutil.rmtree(cache_dir)  # one graph at a time
    partial = cache_dir / "partial"
    partial.mkdir(parents=True)
    row_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(src, minlength=n), out=row_ptr[1:])
    np.save(partial / "row_ptr.npy", row_ptr)
    np.save(partial / "col.npy", dst)
    (partial / "done").write_text("")
    partial.rename(entry)
    return n, src, dst

"""The plain reference of exact BC under the 1-/2-degree heuristics
(numpy and plain PyTorch; it imports nothing of the program).

:func:`decompose` works the 1-degree reduction out again from the input
arcs (paper §3.4.1, one pass), where the heuristics include it: every
vertex of degree 1 leaves the graph, and its neighbour v counts it in
ω(v).  The residual graph keeps the arcs between the others (without the
reduction: every arc, ω = 0); a vertex with a residual arc is *eligible*.
An exact schedule has every eligible vertex as the root of exactly one
column, explicit or derived from a 2-degree triple (§3.4.2); a sampled
one has exactly the roots of :func:`sample_roots`.

:class:`Brandes` runs the columns of a round as direct breadth-first
searches on the residual graph, level by level, each level a CSR product:

    forward:   t = A (σ ⊙ [d = ℓ − 1]);  new = t > 0 ∧ d < 0;  d = ℓ, σ = t on new
    backward:  g = (1 + δ + ω) / σ on d = ℓ + 1;  δ = σ ⊙ (A g) on d = ℓ

and gives the round's contribution Σ_columns (1 + ω_root) δ (the root's
own row excluded), each column's component size n_s = Σ_{d ≥ 0} (1 + ω)
and the round's depth.  A derived column is searched from its own root,
not derived from its neighbours' columns, so the derivation is checked
rather than repeated.  ``dtype`` is the precision the states are kept
in: float64 for the reference, bfloat16 for the control (products then
accumulate in float32, as a bf16 product would, and every state is
rounded to bf16 after each step).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["Decomposition", "decompose", "sample_roots", "round_roots", "check_round",
           "coverage_errors", "Brandes", "RoundRef"]


@dataclasses.dataclass
class Decomposition:
    n: int
    omega: np.ndarray  # f64 [n]: leaf neighbours removed
    res_src: np.ndarray  # int32 residual arcs, sorted by (src, dst)
    res_dst: np.ndarray
    res_deg: np.ndarray  # int64 [n]
    eligible: np.ndarray  # bool [n]: residual degree >= 1

    @property
    def residual_arcs(self) -> int:
        return int(self.res_src.size)

    @property
    def r_total(self) -> float:
        """Vertices whose source contributions the whole schedule accounts
        for: Σ over eligible roots of 1 + ω."""
        return float((1.0 + self.omega[self.eligible]).sum())

    def credit(self, roots: np.ndarray) -> int:
        """Vertices whose source contributions the columns rooted at
        ``roots`` account for: Σ over them of 1 + ω, in int64 (ids past n
        count for nothing; the plan check counts them)."""
        roots = roots[roots < self.n]
        return int(roots.size) + int(self.omega[roots].astype(np.int64).sum())


def decompose(n: int, src: np.ndarray, dst: np.ndarray, reduce: bool = True) -> Decomposition:
    """The one-pass 1-degree reduction of a symmetric arc list, or, with
    ``reduce`` False, the whole graph as the residual one."""
    if reduce:
        deg = np.bincount(src, minlength=n)
        leaf = deg == 1
        omega = np.bincount(dst[leaf[src]], minlength=n).astype(np.float64)
        keep = ~(leaf[src] | leaf[dst])
        res_src, res_dst = src[keep], dst[keep]
    else:
        omega = np.zeros(n, np.float64)
        res_src, res_dst = src, dst
    res_deg = np.bincount(res_src, minlength=n)
    return Decomposition(n=n, omega=omega, res_src=res_src, res_dst=res_dst, res_deg=res_deg,
                         eligible=res_deg >= 1)


def sample_roots(eligible_ids: np.ndarray, k: int, seed: int) -> np.ndarray:
    """The roots of a fixed sample of k (Brandes & Pich 2007): the first k
    entries of a permutation of the eligible ids drawn from ``seed``,
    sorted.  A frozen copy of the definition the program's plan follows,
    drawn here without it."""
    ids = np.asarray(eligible_ids, np.int64)
    return np.sort(np.random.default_rng(seed).permutation(ids)[:k])


def round_roots(sources: np.ndarray, derived: np.ndarray) -> np.ndarray:
    """The root of every live column of a round: its explicit sources,
    then its derived vertices (padding −1 dropped)."""
    return np.concatenate([sources[sources >= 0], derived[derived[:, 0] >= 0, 0]]).astype(
        np.int64)


def _neighbours(dec: Decomposition, v: int) -> np.ndarray:
    lo, hi = np.searchsorted(dec.res_src, [v, v + 1])
    return dec.res_dst[lo:hi]


def check_round(dec: Decomposition, sources: np.ndarray, derived: np.ndarray) -> int:
    """Faults of one round's plan: a root that is not eligible or appears
    twice, a derived vertex whose residual neighbours are not the two
    explicit sources its row names."""
    errors = 0
    roots = round_roots(sources, derived)
    errors += int((~dec.eligible[roots]).sum()) + (roots.size - np.unique(roots).size)
    for c, a_pos, b_pos in derived[derived[:, 0] >= 0]:
        nb = _neighbours(dec, int(c))
        ok = (0 <= a_pos < sources.size and 0 <= b_pos < sources.size and nb.size == 2
              and sorted((int(sources[a_pos]), int(sources[b_pos]))) == sorted(nb.tolist()))
        errors += int(not ok)
    return errors


def coverage_errors(dec: Decomposition, all_roots: np.ndarray, want_roots: np.ndarray) -> int:
    """How far the schedule's roots are from each of ``want_roots`` exactly
    once: roots missing, repeated or not wanted."""
    counts = np.bincount(all_roots, minlength=dec.n) if all_roots.size else np.zeros(dec.n, int)
    want = np.bincount(want_roots, minlength=dec.n)
    return int(np.abs(counts[: dec.n] - want).sum()) + int((all_roots >= dec.n).sum())


@dataclasses.dataclass
class RoundRef:
    bc: torch.Tensor  # [n] contribution, in the Brandes dtype
    ns: np.ndarray  # f64 [columns]
    levels: int  # max depth + 1


class Brandes:
    """Level-synchronous Brandes on the residual graph (see the module
    docstring), on ``device`` in ``dtype`` (float64 or bfloat16)."""

    def __init__(self, dec: Decomposition, device: torch.device,
                 dtype: torch.dtype = torch.float64):
        if dtype not in (torch.float64, torch.bfloat16):
            raise ValueError(f"dtype must be float64 or bfloat16, got {dtype}")
        self.n = dec.n
        self.device = device
        self.dtype = dtype
        self.acc = torch.float64 if dtype == torch.float64 else torch.float32
        row_ptr = np.zeros(dec.n + 1, np.int64)
        np.cumsum(dec.res_deg, out=row_ptr[1:])
        idx = torch.int32 if dec.residual_arcs < 2**31 else torch.int64
        self.adj = torch.sparse_csr_tensor(
            torch.from_numpy(row_ptr).to(device=device, dtype=idx),
            torch.from_numpy(dec.res_dst).to(device=device, dtype=idx),
            torch.ones(dec.residual_arcs, dtype=self.acc, device=device),
            size=(dec.n, dec.n), check_invariants=False,
        )
        self.omega = torch.from_numpy(dec.omega).to(device=device, dtype=dtype)

    def _product(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sparse.mm(self.adj, x.to(self.acc)).to(self.dtype)

    def round(self, roots: np.ndarray) -> RoundRef:
        n, dt, dev = self.n, self.dtype, self.device
        k = roots.size
        cols = torch.arange(k, device=dev)
        r = torch.from_numpy(roots).to(dev)
        sigma = torch.zeros((n, k), dtype=dt, device=dev)
        depth = torch.full((n, k), -1, dtype=torch.int32, device=dev)
        sigma[r, cols] = 1
        depth[r, cols] = 0
        lvl = 0
        while True:
            t = self._product(torch.where(depth == lvl, sigma, 0))
            new = (t > 0) & (depth < 0)
            if not bool(new.any()):
                break
            lvl += 1
            depth = torch.where(new, lvl, depth)
            sigma = torch.where(new, t, sigma)
        one = torch.ones((), dtype=dt, device=dev)
        om = self.omega[:, None]
        delta = torch.zeros_like(sigma)
        safe = torch.where(sigma > 0, sigma, one)
        for level in range(lvl - 1, 0, -1):
            g = torch.where(depth == level + 1, (one + delta + om) / safe, 0)
            t = self._product(g)
            delta = torch.where(depth == level, sigma * t, delta)
        contrib = delta * (one + self.omega[r])[None, :]
        contrib[r, cols] = 0
        bc = contrib.to(self.acc).sum(dim=1).to(dt)
        ns = torch.where(depth >= 0, one + om, 0).to(self.acc).sum(dim=0).to(dt)
        return RoundRef(bc=bc, ns=ns.double().cpu().numpy(), levels=lvl + 1)

"""Source-sampled approximate BC: the root-subset plan (numpy).

Brandes' outer loop is a sum of independent per-root contributions, so a
uniform k-subset of the eligible roots gives the unbiased estimator
BC_hat(v) = (N / k) · Σ_{s ∈ sample} contribution_s(v) (Brandes & Pich
2007).  :func:`plan_sampling` draws the subset as a prefix of a seeded
permutation, so the same seed gives the same roots as the JAX package and
samples are nested in k.  ``sampling="fixed"`` is the normal way to run a
few rounds of a large graph; ``"adaptive"`` (the rank-stability stop
rule) is not ported yet.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "SAMPLING_MODES",
    "normalize_sampling",
    "eligible_roots",
    "resolve_sample_size",
    "SamplePlan",
    "plan_sampling",
]

#: "off" runs every eligible root (exact); "fixed" runs a seeded k-root
#: subset and rescales by N/k; "adaptive" also stops once the top-k ranks
#: stabilize (not ported yet).
SAMPLING_MODES = ("off", "fixed", "adaptive")


def normalize_sampling(mode: str | None) -> str:
    """Validate a sampling mode string (None means "off")."""
    mode = "off" if mode is None else mode
    if mode not in SAMPLING_MODES:
        raise ValueError(
            f"unknown sampling mode {mode!r}; expected one of {SAMPLING_MODES}"
        )
    if mode == "adaptive":
        raise NotImplementedError(
            "sampling='adaptive' (the rank-stability stop rule) is not "
            "ported yet (ROADMAP Queue 1, sampling and serving); use "
            "sampling='fixed'"
        )
    return mode


def eligible_roots(graph) -> np.ndarray:
    """Traversal-worthy source ids under ``heuristics="h0"`` (degree ≥ 1)."""
    return np.nonzero(graph.degrees() >= 1)[0].astype(np.int64)


def resolve_sample_size(
    num_eligible: int,
    sample_frac: float | None = None,
    sample_k: int | None = None,
) -> int:
    """Resolve the sample size k from exactly one of frac / k."""
    if sample_frac is not None and sample_k is not None:
        raise ValueError("pass sample_frac or sample_k, not both")
    if sample_k is not None:
        k = int(sample_k)
        if k < 1:
            raise ValueError(f"sample_k must be >= 1, got {sample_k}")
        if k > num_eligible:
            raise ValueError(
                f"sample_k={k} exceeds the {num_eligible} eligible roots"
            )
        return k
    frac = 1.0 if sample_frac is None else float(sample_frac)
    if not 0.0 < frac <= 1.0:
        raise ValueError(f"sample_frac must be in (0, 1], got {sample_frac}")
    return max(1, min(num_eligible, int(round(frac * num_eligible))))


@dataclasses.dataclass(frozen=True)
class SamplePlan:
    """A resolved root-sampling decision (``roots`` is None when the
    sample is the whole eligible pool: the schedule is then the exact one)."""

    mode: str  # one of SAMPLING_MODES
    roots: np.ndarray | None  # sorted sampled root ids; None = all eligible
    num_eligible: int
    k: int  # sample size (== num_eligible when roots is None)
    seed: int

    @property
    def scale(self) -> float:
        """The a-priori estimator rescale N/k."""
        return self.num_eligible / self.k if self.k else 1.0


def plan_sampling(
    eligible: np.ndarray,
    mode: str,
    sample_frac: float | None = None,
    sample_k: int | None = None,
    seed: int = 0,
) -> SamplePlan:
    """Draw the seeded root subset: the first k entries of a seeded
    permutation of the eligible pool, returned sorted."""
    mode = normalize_sampling(mode)
    eligible = np.asarray(eligible, np.int64)
    num_eligible = int(eligible.size)
    if mode == "off":
        return SamplePlan(
            mode=mode, roots=None, num_eligible=num_eligible,
            k=num_eligible, seed=seed,
        )
    if num_eligible == 0:
        raise ValueError("cannot sample roots from a graph with no edges")
    k = resolve_sample_size(num_eligible, sample_frac, sample_k)
    if k >= num_eligible:
        roots = None  # exact-schedule identity, no rescale drift
    else:
        rng = np.random.default_rng(seed)
        roots = np.sort(rng.permutation(eligible)[:k])
    return SamplePlan(
        mode=mode, roots=roots, num_eligible=num_eligible, k=k, seed=seed
    )

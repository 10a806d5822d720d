"""Source-sampled approximate BC: the root-subset plan (numpy).

Brandes' outer loop is a sum of independent per-root contributions, so a
uniform k-subset of the eligible roots gives the unbiased estimator
BC_hat(v) = (N / k) · Σ_{s ∈ sample} contribution_s(v) (Brandes & Pich
2007).  :func:`plan_sampling` draws the subset as a prefix of a seeded
permutation, so the same seed gives the same roots as the JAX package and
samples are nested in k.  ``sampling="fixed"`` is the normal way to run a
few rounds of a large graph; ``"adaptive"`` draws the same plan and lets
:class:`AdaptiveStopRule` end the run once the top-k ranks stop moving.
The stop rules are the driver's ``stop_rule`` seam: ``(bc_running f64
[n], blocks_done) -> bool`` after every dispatch block.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .. import tracing

__all__ = [
    "SAMPLING_MODES",
    "normalize_sampling",
    "eligible_roots",
    "resolve_sample_size",
    "SamplePlan",
    "plan_sampling",
    "RANK_METHODS",
    "top_k_indices",
    "rank_stability",
    "AdaptiveStopRule",
    "BlockBudgetStop",
]

#: "off" runs every eligible root (exact); "fixed" runs a seeded k-root
#: subset and rescales by N/k; "adaptive" also stops once the top-k ranks
#: stabilize.
SAMPLING_MODES = ("off", "fixed", "adaptive")

#: rank-agreement metrics of :func:`rank_stability`
RANK_METHODS = ("jaccard", "kendall")


def normalize_sampling(mode: str | None) -> str:
    """Validate a sampling mode string (None means "off")."""
    mode = "off" if mode is None else mode
    if mode not in SAMPLING_MODES:
        raise ValueError(
            f"unknown sampling mode {mode!r}; expected one of {SAMPLING_MODES}"
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
        with tracing.phase("bc.sample.plan"):
            rng = np.random.default_rng(seed)
            roots = np.sort(rng.permutation(eligible)[:k])
    return SamplePlan(
        mode=mode, roots=roots, num_eligible=num_eligible, k=k, seed=seed
    )


def top_k_indices(scores: np.ndarray, k: int) -> np.ndarray:
    """Indices of the k largest scores, ties broken by lowest vertex id
    (deterministic across runs and accumulation orders)."""
    scores = np.asarray(scores)
    k = min(int(k), scores.size)
    # lexsort: primary key -scores ascending == scores descending,
    # secondary key vertex id ascending
    order = np.lexsort((np.arange(scores.size), -scores))
    return order[:k]


def rank_stability(
    prev: np.ndarray, cur: np.ndarray, k: int = 10, method: str = "jaccard"
) -> float:
    """Rank agreement of two score vectors' top-k, in [0, 1]; 1.0 iff
    the top-k view is unchanged.

    ``"jaccard"``: |top-k(prev) ∩ top-k(cur)| / |union| — set stability,
    blind to order inside the top-k.  ``"kendall"``: fraction of
    concordant pairs over the union of the two top-k sets (a bounded
    Kendall-tau variant; ties concordant with ties) — also sensitive to
    reordering *within* the set.  Both are scale-invariant, so watching
    the unscaled running accumulator is equivalent to watching BC_hat.
    """
    if method not in RANK_METHODS:
        raise ValueError(
            f"unknown rank method {method!r}; expected one of {RANK_METHODS}"
        )
    a = top_k_indices(prev, k)
    b = top_k_indices(cur, k)
    union = np.union1d(a, b)
    if union.size == 0:
        return 1.0
    if method == "jaccard":
        inter = np.intersect1d(a, b, assume_unique=True).size
        return float(inter) / float(union.size)
    if union.size == 1:
        return 1.0
    pa = np.sign(np.asarray(prev, np.float64)[union][:, None]
                 - np.asarray(prev, np.float64)[union][None, :])
    pb = np.sign(np.asarray(cur, np.float64)[union][:, None]
                 - np.asarray(cur, np.float64)[union][None, :])
    iu = np.triu_indices(union.size, k=1)
    concordant = int((pa[iu] == pb[iu]).sum())
    return concordant / float(iu[0].size)


class AdaptiveStopRule:
    """``BCDriver`` stop-rule seam: stop once top-k ranks stabilize.

    Called as ``rule(bc_running, blocks_done)`` after each drained
    dispatch block with the running f64 accumulator.  The rule compares
    the accumulator's top-k against the previous check's
    (:func:`rank_stability`) and fires once the agreement has been
    ``>= threshold`` for ``window`` *consecutive* checks — but never
    before ``min_blocks`` dispatch blocks have completed, so a lucky
    first block cannot truncate the sample to something tiny.

    An unchanged accumulator scores exactly 1.0, so the default
    ``threshold=1.0`` means "the top-k set stopped moving".  Telemetry
    lands in ``stats`` (and, via the driver, ``BCResult.stop_stats``).
    """

    def __init__(
        self,
        top_k: int = 10,
        window: int = 2,
        min_blocks: int = 3,
        threshold: float = 1.0,
        method: str = "jaccard",
    ):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if min_blocks < 1:
            raise ValueError(f"min_blocks must be >= 1, got {min_blocks}")
        if method not in RANK_METHODS:
            raise ValueError(
                f"unknown rank method {method!r}; expected one of {RANK_METHODS}"
            )
        self.top_k = int(top_k)
        self.window = int(window)
        self.min_blocks = int(min_blocks)
        self.threshold = float(threshold)
        self.method = method
        self._prev: np.ndarray | None = None
        self._streak = 0
        self.stats: dict = {
            "rule": "adaptive",
            "top_k": self.top_k,
            "window": self.window,
            "min_blocks": self.min_blocks,
            "threshold": self.threshold,
            "method": method,
            "checks": 0,
            "stability": [],  # per-check rank_stability history
            "fired_at_block": None,
        }

    def __call__(self, bc: np.ndarray, blocks_done: int) -> bool:
        bc = np.asarray(bc, np.float64)
        self.stats["checks"] += 1
        if self._prev is not None:
            s = rank_stability(self._prev, bc, self.top_k, self.method)
            self.stats["stability"].append(float(s))
            self._streak = self._streak + 1 if s >= self.threshold else 0
        self._prev = bc.copy()
        fire = blocks_done >= self.min_blocks and self._streak >= self.window
        if fire and self.stats["fired_at_block"] is None:
            self.stats["fired_at_block"] = int(blocks_done)
        return fire


class BlockBudgetStop:
    """Stop after a fixed number of dispatch blocks (serving refresh
    slices: each background generation runs ``max_blocks`` more blocks
    of the *same* checkpointed schedule, then publishes)."""

    def __init__(self, max_blocks: int):
        if max_blocks < 1:
            raise ValueError(f"max_blocks must be >= 1, got {max_blocks}")
        self.max_blocks = int(max_blocks)
        self.stats: dict = {
            "rule": "budget",
            "max_blocks": self.max_blocks,
            "checks": 0,
            "fired_at_block": None,
        }

    def __call__(self, bc: np.ndarray, blocks_done: int) -> bool:
        del bc
        self.stats["checks"] += 1
        fire = blocks_done >= self.max_blocks
        if fire and self.stats["fired_at_block"] is None:
            self.stats["fired_at_block"] = int(blocks_done)
        return fire

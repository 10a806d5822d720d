"""Exactly-once accounting of BC rounds, elasticity planning, and the
round loop's errors.

BC rounds are idempotent and additive, so recovery is re-issue, never
partial-state repair.  :class:`RoundLedger` records committed rounds so a
duplicated execution never double-counts; :class:`BCCheckpoint`
(re-exported from :mod:`repro_torch.checkpoint.checkpointer`) pairs the
committed set with the partial BC sums on disk, tied to one schedule by
:func:`schedule_fingerprint`.  :func:`plan_elastic_remesh` maps a device
loss to a smaller grid (whole replicas first), and
:class:`StragglerPolicy` is the standalone median detector of backup
tasks; the round loop's own straggler policies are
:data:`repro_torch.core.driver.STRAGGLER_POLICIES`.  The exceptions are
the driver's recovery vocabulary: :class:`TransientRoundError` is retried
in place, :class:`ReplicaLostError` never is (the multi-ledger loop
re-meshes around it), :class:`IntegrityError` ends a block that keeps
failing its audit.
"""
from __future__ import annotations

import collections
import dataclasses
import statistics
import zlib

__all__ = [
    "MeshPlan",
    "plan_elastic_remesh",
    "StragglerPolicy",
    "RoundLedger",
    "BCCheckpoint",
    "schedule_fingerprint",
    "TransientRoundError",
    "ReplicaLostError",
    "IntegrityError",
    "is_transient_error",
]


class IntegrityError(RuntimeError):
    """A round output failed its integrity audit beyond recovery: the
    block kept failing the ABFT checksum / claim / output-domain audits
    (``integrity="audit"|"checksum"``) after the re-dispatch budget and
    the fallback recompute (when one was given) were spent."""


class TransientRoundError(RuntimeError):
    """A round failure worth retrying on the same devices.  The driver
    retries it, and the runtime error types named in
    :data:`TRANSIENT_ERROR_NAMES`, within its retry budget; any other
    exception propagates."""


class ReplicaLostError(RuntimeError):
    """A sub-cluster replica's devices are gone; carries the lost
    ``replica`` index (-1 when unknown, as the watchdog raises it).
    Never retried in place."""

    def __init__(self, replica: int, message: str | None = None):
        super().__init__(message or f"replica {replica} lost")
        self.replica = int(replica)


#: Exception type *names* treated as transient alongside
#: :class:`TransientRoundError` — the JAX package's list, matched by name
#: so the check imports no backend module.
TRANSIENT_ERROR_NAMES = ("XlaRuntimeError", "UnavailableError", "InternalError")


def is_transient_error(exc: BaseException) -> bool:
    """True when a round failure should be retried in place."""
    if isinstance(exc, TransientRoundError):
        return True
    if isinstance(exc, ReplicaLostError):
        return False
    return type(exc).__name__ in TRANSIENT_ERROR_NAMES


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    shape: tuple[int, ...]
    axes: tuple[str, ...]
    reload_from_checkpoint: bool
    reshard_params: bool
    note: str


def plan_elastic_remesh(
    current_shape: tuple[int, ...],
    axes: tuple[str, ...],
    devices_lost: int,
) -> MeshPlan:
    """Shrink policy: drop whole replica ('pod') groups first, then halve
    the 'data' axis; never touch 'model' (weight layout).  The JAX
    package's planner, decision for decision."""
    shape = list(current_shape)
    n = 1
    for s in shape:
        n *= s
    remaining = n - devices_lost
    if remaining <= 0:
        raise ValueError("no devices left")
    if "pod" in axes:
        pod_ax = axes.index("pod")
        per_pod = n // shape[pod_ax]
        pods_left = remaining // per_pod
        if pods_left >= 1:
            if pods_left != shape[pod_ax]:
                shape[pod_ax] = pods_left
                return MeshPlan(
                    shape=tuple(shape),
                    axes=axes,
                    reload_from_checkpoint=False,  # replicas hold full state
                    reshard_params=False,
                    note=f"dropped to {pods_left} pods; surviving replicas "
                    f"re-deal the remaining source rounds",
                )
            return MeshPlan(tuple(shape), axes, False, False, "no change")
    data_ax = axes.index("data")
    while True:
        prod = 1
        for s in shape:
            prod *= s
        if prod <= remaining:
            break
        if shape[data_ax] % 2 != 0 or shape[data_ax] == 1:
            raise ValueError(f"cannot shrink mesh {current_shape} to {remaining}")
        shape[data_ax] //= 2
    return MeshPlan(
        shape=tuple(shape),
        axes=axes,
        reload_from_checkpoint=True,
        reshard_params=True,
        note="data axis halved; params resharded from checkpoint, "
        "global batch rescaled",
    )


class StragglerPolicy:
    """Median-based speculative re-execution (MapReduce backup tasks): a
    detector for external orchestration; the BC round loop uses its own
    multi-ledger scheduler (``BCDriver(straggler="steal"|"redeal")``)."""

    def __init__(self, factor: float = 2.0, min_samples: int = 5, window: int = 512):
        self.factor = factor
        self.min_samples = min_samples
        # bounded history: a long-lived service observes millions of
        # rounds, and the median needs only the recent regime
        self.times: collections.deque[float] = collections.deque(maxlen=window)

    def observe(self, seconds: float) -> None:
        self.times.append(seconds)

    def should_speculate(self, elapsed: float) -> bool:
        if len(self.times) < self.min_samples:
            return False
        return elapsed > self.factor * statistics.median(self.times)


class RoundLedger:
    """Exactly-once commit of additive work units (BC rounds).

    :class:`repro_torch.core.driver.BCDriver` consumes a ledger directly:
    committed rounds are skipped, so a round is accumulated exactly once.
    The ledger is in-memory only; durable kill-and-resume is
    :class:`BCCheckpoint`, which stores the committed set together with
    the matching partial BC sums.
    """

    def __init__(self):
        self._committed: set[int] = set()

    def try_commit(self, round_id: int) -> bool:
        """True if this result should be accumulated (first completion)."""
        if round_id in self._committed:
            return False
        self._committed.add(round_id)
        return True

    def is_committed(self, round_id: int) -> bool:
        """Read-only commit check."""
        return round_id in self._committed

    def merge(self, other: "RoundLedger") -> int:
        """Absorb (move) another ledger's committed set into this one;
        returns the number of rounds newly committed here."""
        added = len(other._committed - self._committed)
        self._committed |= other._committed
        other._committed = set()
        return added

    def pending(self, total_rounds: int) -> list[int]:
        return [r for r in range(total_rounds) if r not in self._committed]

    def state(self) -> list[int]:
        return sorted(self._committed)

    @classmethod
    def from_state(cls, committed: list[int]) -> "RoundLedger":
        led = cls()
        led._committed = set(committed)
        return led


# the durable (partial BC, n_s, committed rounds) triple lives with the
# rest of the durable state; re-exported here beside the ledger protocol
# it completes, as in the JAX package
from ..checkpoint.checkpointer import BCCheckpoint  # noqa: E402


def schedule_fingerprint(n: int, schedule) -> str:
    """Content hash tying a checkpoint to one (graph, schedule) pair —
    the JAX package's string, byte for byte."""
    crc = 0
    for rnd in schedule.rounds:
        crc = zlib.crc32(rnd.sources.tobytes(), crc)
        crc = zlib.crc32(rnd.derived.tobytes(), crc)
    return (
        f"n{n}_b{schedule.batch_size}_k{schedule.derived_per_round}_"
        f"r{len(schedule.rounds)}_{crc:08x}"
    )

"""Exactly-once accounting of BC rounds.

BC rounds are idempotent and additive, so recovery is re-issue, never
partial-state repair.  :class:`RoundLedger` records committed rounds so a
duplicated execution never double-counts.  The durable checkpoint that
pairs it with the partial BC sums arrives with the next slice.
"""
from __future__ import annotations

__all__ = ["RoundLedger"]


class RoundLedger:
    """Exactly-once commit of additive work units (BC rounds).

    :class:`repro_torch.core.driver.BCDriver` consumes a ledger directly:
    committed rounds are skipped, so a round is accumulated exactly once.
    The ledger is in-memory only.
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

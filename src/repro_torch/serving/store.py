"""Versioned in-memory BC snapshots for the serving front end.

A :class:`BCSnapshotStore` holds exactly one *immutable* current
snapshot and swaps it atomically when the background refresher publishes
a new generation: a publish builds the :class:`BCSnapshot` completely
and then replaces the store's single reference, so a reader that grabbed
the old reference keeps a self-consistent view forever and a reader
arriving mid-publish sees either the old or the new generation — never a
mix (the atomicity test in tests/test_serving.py races a reader against
a publisher to prove it).

Queries account themselves in ``stats`` — every query is exactly one of
``hits`` (served from a settled snapshot), ``stale_hits`` (served while
a refresh is in flight: the answer is valid but a fresher generation is
seconds away — the serving layer's X-Cache-Status: STALE analogue), or
``misses`` (no snapshot published yet), so
``queries == hits + stale_hits + misses`` always holds.

Durability comes from composing with
:class:`repro_torch.checkpoint.checkpointer.BCCheckpoint`:
:meth:`BCSnapshotStore.publish_from_checkpoint` turns the checkpoint's
latest committed prefix (bc accumulator + per-root component sizes) into
a published generation, which is how a killed background refresher's
replacement resumes serving from the last *committed* state instead of
recomputing from scratch.
"""
from __future__ import annotations

import dataclasses
import threading

import numpy as np

from .sampling import top_k_indices

__all__ = ["BCSnapshot", "BCSnapshotStore"]


@dataclasses.dataclass(frozen=True)
class BCSnapshot:
    """One immutable published generation (treat ``bc`` as read-only)."""

    generation: int
    bc: np.ndarray  # f64 [n] rescaled BC estimate
    meta: dict


class BCSnapshotStore:
    """Single-slot versioned snapshot store (see module docstring).

    Readers never take the write lock: the current snapshot is one
    attribute read (atomic under the GIL), and snapshots are immutable
    once published.  The write lock only serializes publishers so
    generation numbers stay monotonic.
    """

    def __init__(self):
        self._current: BCSnapshot | None = None
        self._write_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._refreshing = False
        self.stats: dict = {
            "queries": 0,
            "hits": 0,
            "misses": 0,
            "stale_hits": 0,
            "publishes": 0,
        }

    # ------------------------------------------------------- publishing
    def publish(self, bc: np.ndarray, meta: dict | None = None) -> int:
        """Atomically swap in a new generation; returns its number."""
        bc = np.array(bc, np.float64, copy=True)  # immutable by isolation
        with self._write_lock:
            gen = (self._current.generation if self._current else 0) + 1
            snap = BCSnapshot(generation=gen, bc=bc, meta=dict(meta or {}))
            # the swap: one reference assignment — readers see old or new,
            # never a partially-built snapshot
            self._current = snap
        with self._stats_lock:
            self.stats["publishes"] += 1
        return gen

    def publish_from_checkpoint(
        self,
        checkpoint,
        fingerprint: str | None = None,
        *,
        num_eligible: int | None = None,
        meta: dict | None = None,
    ) -> int | None:
        """Publish the checkpoint's latest committed prefix (resume path).

        The checkpoint stores the *raw* (unscaled) accumulator; with
        ``num_eligible`` the estimator rescale N/k is recomputed here
        from the committed per-root component-size ledger (one entry per
        accumulated root under "h0" — the only heuristics mode sampling
        composes with).  Returns the published generation, or None when
        no readable snapshot exists (cold start).
        """
        bc, ns_by_root, committed = checkpoint.load(fingerprint)
        if bc is None:
            return None
        roots_done = len(ns_by_root)
        scale = 1.0
        if num_eligible is not None and roots_done:
            scale = float(num_eligible) / float(roots_done)
        info = {
            "source": "checkpoint",
            "checkpoint_generation": getattr(
                checkpoint, "loaded_generation", None
            ),
            "committed_rounds": len(committed),
            "roots_accumulated": roots_done,
            "scale": scale,
        }
        info.update(meta or {})
        return self.publish(bc * scale if scale != 1.0 else bc, info)

    # ------------------------------------------------ refresh lifecycle
    def begin_refresh(self) -> None:
        """Mark a background refresh in flight: queries served until
        :meth:`end_refresh` count as ``stale_hits``."""
        self._refreshing = True

    def end_refresh(self) -> None:
        self._refreshing = False

    @property
    def refreshing(self) -> bool:
        return self._refreshing

    # ---------------------------------------------------------- queries
    @property
    def generation(self) -> int:
        snap = self._current
        return snap.generation if snap else 0

    def snapshot(self) -> BCSnapshot | None:
        """The current snapshot reference, without query accounting
        (internal/test hook; serving queries go through top_k/score)."""
        return self._current

    def _account(self, snap: BCSnapshot | None) -> None:
        with self._stats_lock:
            self.stats["queries"] += 1
            if snap is None:
                self.stats["misses"] += 1
            elif self._refreshing:
                self.stats["stale_hits"] += 1
            else:
                self.stats["hits"] += 1

    def top_k(self, k: int) -> tuple[BCSnapshot, list[tuple[int, float]]] | None:
        """The k highest-BC vertices of the current generation as
        ``(snapshot, [(vertex, score), ...])`` — the snapshot rides along
        so the caller knows which generation answered.  None on a miss.
        """
        snap = self._current  # grab the reference once: self-consistent
        self._account(snap)
        if snap is None:
            return None
        idx = top_k_indices(snap.bc, k)
        return snap, [(int(v), float(snap.bc[v])) for v in idx]

    def score(self, vertex: int) -> tuple[BCSnapshot, float] | None:
        """One vertex's BC estimate from the current generation
        (``(snapshot, score)``), or None on a miss."""
        snap = self._current
        self._account(snap)
        if snap is None:
            return None
        return snap, float(snap.bc[int(vertex)])

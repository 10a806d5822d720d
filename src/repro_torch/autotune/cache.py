"""Persistent measured-cost cache behind the tile, hybrid, overlap and
straggler-prior picks of the 2-D path.

The roofline model (:mod:`repro_torch.roofline.model`) prices every
candidate configuration; this cache holds what a configuration *measured*
(:mod:`repro_torch.autotune.measure`), so that the four choice seams —
the hybrid per-cell kernel choice, ``overlap="auto"``, the straggler
EWMA prior and the BCSR tile pick — read a measurement before they fall
back to the model.

Keys (measure-once: the same run repeated finds its records):

  graph key  — graph stats + grid shape: ``n{n}_m{m}_r{R}x{C}x{fr}_``
               ``t{nnz_tiles}_k{skew}``, ``skew`` the degree skew
               ``max(deg)/mean(deg)`` to one decimal (R-MAT and uniform
               graphs land on different keys).
  config key — candidate configuration: ``{engine}|{overlap}|b{batch}|``
               ``t{bm}x{bk}`` (``t-`` for untiled engines).

A record under (graph key, config key) is the measured per-level wall
seconds of that configuration; the hit / miss / store counters make the
round trip auditable.

The file format, :data:`CACHE_VERSION` and the graph-key schema are the
JAX package's, so either package reads the other's file.  Config keys
carry each package's own engine names (the port's ``fused``,
``fused_sparse``, ``fused_hybrid``), so the other package's ``pallas*``
records load without error and never hit.  A wall belongs to the machine
that measured it: a file is worth carrying only between runs on the same
kind of device.

The JSON file is versioned and corrupt-tolerant: an unreadable or
wrong-version file is logged and treated as empty.  ``path=None`` keeps
the cache in memory.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import pathlib
import tempfile

import numpy as np

__all__ = [
    "AUTOTUNE_MODES",
    "CACHE_VERSION",
    "CostCache",
    "CostRecord",
    "as_cache",
    "config_key",
    "graph_key",
    "graph_key_for",
    "normalize_autotune",
]

logger = logging.getLogger(__name__)

#: autotune modes:
#:   "off"     — roofline only (default; no cache, no timing)
#:   "cache"   — read the cache; on a miss fall back to the roofline,
#:               never measure
#:   "measure" — read the cache; on a miss time the candidate and record
#:               it (the next run hits)
AUTOTUNE_MODES = ("off", "cache", "measure")

CACHE_VERSION = 1


def normalize_autotune(mode: str | None) -> str:
    """Validate an ``autotune=`` mode (None ⇒ "off")."""
    if mode is None:
        return "off"
    if mode not in AUTOTUNE_MODES:
        raise ValueError(f"autotune must be one of {AUTOTUNE_MODES}, got {mode!r}")
    return mode


def graph_key(n: int, m: int, *, R: int, C: int, fr: int = 1, nnz_tiles: int = 0,
              degree_skew: float = 1.0) -> str:
    """Graph-stats + grid-shape cache key (see the module docstring)."""
    return (f"n{int(n)}_m{int(m)}_r{int(R)}x{int(C)}x{int(fr)}"
            f"_t{int(nnz_tiles)}_k{float(degree_skew):.1f}")


def graph_key_for(partition, graph=None, *, fr: int = 1, nnz_tiles: int = 0) -> str:
    """Graph key of a :class:`~repro_torch.graphs.partition.TwoDPartition`
    (and the graph, for the degree skew; without it the skew is 1).
    ``nnz_tiles`` is 0 unless the caller already counted tiles: the key
    only has to be stable across runs of one configuration."""
    m = int(partition.arc_counts.sum())
    if graph is not None and graph.n > 0:
        deg = graph.degrees().astype(np.float64)
        skew = float(deg.max() / max(deg.mean(), 1.0))
    else:
        skew = 1.0
    return graph_key(partition.n, m, R=partition.R, C=partition.C, fr=fr,
                     nnz_tiles=nnz_tiles, degree_skew=skew)


def config_key(engine_kind: str, overlap: str, batch_size: int,
               tile: tuple[int, int] | None = None) -> str:
    """Candidate-configuration cache key (see the module docstring)."""
    t = f"t{int(tile[0])}x{int(tile[1])}" if tile is not None else "t-"
    return f"{engine_kind}|{overlap}|b{int(batch_size)}|{t}"


@dataclasses.dataclass(frozen=True)
class CostRecord:
    """One measured configuration: per-level wall seconds and the walls."""

    level_s: float
    levels: int = 0
    walls: tuple[float, ...] = ()

    def to_json(self) -> dict:
        return {"level_s": self.level_s, "levels": self.levels, "walls": list(self.walls)}

    @classmethod
    def from_json(cls, obj: dict) -> "CostRecord":
        return cls(level_s=float(obj["level_s"]), levels=int(obj.get("levels", 0)),
                   walls=tuple(float(w) for w in obj.get("walls", ())))


class CostCache:
    """Persistent JSON cost cache with hit / miss / store counters.

    ``path=None`` keeps it in memory.  It loads at construction (a corrupt
    or wrong-version file counts as empty, with a warning) and saves
    atomically (a temporary file renamed over the old one) on every
    :meth:`put`, so a killed run loses no earlier record.
    """

    def __init__(self, path: str | os.PathLike | None = None):
        self.path = pathlib.Path(path) if path is not None else None
        self.entries: dict[str, dict[str, CostRecord]] = {}
        self.hits = 0
        self.misses = 0
        self.stores = 0
        self._load()

    def _load(self) -> None:
        if self.path is None or not self.path.exists():
            return
        try:
            obj = json.loads(self.path.read_text())
        except (OSError, ValueError) as e:  # bad JSON or bytes that are not UTF-8
            logger.warning("autotune cache %s is unreadable (%s: %s); starting empty",
                           self.path, type(e).__name__, e)
            return
        if not isinstance(obj, dict) or obj.get("version") != CACHE_VERSION:
            logger.warning("autotune cache %s has an unexpected version/shape (want version "
                           "%s); starting empty", self.path, CACHE_VERSION)
            return
        for gkey, configs in obj.get("entries", {}).items():
            try:
                self.entries[gkey] = {ckey: CostRecord.from_json(rec)
                                      for ckey, rec in configs.items()}
            except (KeyError, TypeError, ValueError, AttributeError):
                logger.warning("autotune cache %s: malformed record group %s skipped",
                               self.path, gkey)

    def save(self) -> None:
        if self.path is None:
            return
        obj = {"version": CACHE_VERSION,
               "entries": {gkey: {ckey: rec.to_json() for ckey, rec in configs.items()}
                           for gkey, configs in self.entries.items()}}
        self.path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=str(self.path.parent), prefix=self.path.name,
                                   suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(obj, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def get(self, gkey: str, ckey: str) -> CostRecord | None:
        rec = self.entries.get(gkey, {}).get(ckey)
        if rec is None:
            self.misses += 1
        else:
            self.hits += 1
        return rec

    def put(self, gkey: str, ckey: str, record: CostRecord) -> None:
        self.entries.setdefault(gkey, {})[ckey] = record
        self.stores += 1
        self.save()

    def num_records(self) -> int:
        return sum(len(c) for c in self.entries.values())

    def stats(self) -> dict:
        return {"path": str(self.path) if self.path else None, "records": self.num_records(),
                "hits": self.hits, "misses": self.misses, "stores": self.stores}


def as_cache(cache) -> CostCache:
    """A ``CostCache | path | None`` as a :class:`CostCache`."""
    if isinstance(cache, CostCache):
        return cache
    return CostCache(cache)

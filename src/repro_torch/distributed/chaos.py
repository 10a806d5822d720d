"""Deterministic fault injection for the BC driver (the chaos harness).

The driver's self-healing round loop (:class:`repro_torch.core.driver.BCDriver`:
retry with backoff, numeric quarantine, the audits, the watchdog, the
re-mesh around a lost replica, generational snapshots) exists to survive
transient failures, lost replicas and torn writes; this module makes each
of them reproducible on demand, so that the recovery paths are tested
and can be replayed from the command line (``launch/bc.py --chaos``).

Faults are *declared* up front in a seeded :class:`FaultPlan` and
*injected* by wrappers at two seams: the ``round_fn`` call
(:class:`ChaosRoundFn`) and the durable-file writes (:class:`ChaosFS`,
through :class:`ChaosCheckpoint` and :func:`ChaosCostCache`).  No
production path is patched or branched: a chaos run is the production run
with wrapped callables.

The fault classes (:data:`FAULT_KINDS`), each keyed on a deterministic
counter (dispatch call, checkpoint save, cache put):

  ``transient``  raise :class:`TransientRoundError` for ``count``
                 consecutive dispatch calls from ``at`` — the driver must
                 retry with backoff and succeed.
  ``poison``     multiply the block's ``bc`` / ``ns`` outputs by NaN (or
                 Inf, ``:inf``) — the numeric guard must quarantine the
                 block, re-dispatch it, and fall back to the clean round
                 function if the poison persists.
  ``kill``       replica ``:rI`` is lost from call ``at`` on — the wrapper
                 raises :class:`ReplicaLostError` whenever that lane is
                 dealt live (non-padding) columns; once the driver has
                 re-meshed, the dead lane gets only padding and the
                 wrapper stays silent.
  ``crash``      raise :class:`ChaosCrash` at call ``at`` — a simulated
                 process death (never retried), for kill-and-resume tests.
  ``torn``       truncate the snapshot the ``at``-th checkpoint save just
                 wrote — the next load must fall back a generation.
  ``cache``      garble the autotune cache file after its ``at``-th put —
                 the next run must start empty with a warning.
  ``flip``       *finite* corruption of the block the ``at``-th dispatch
                 returned, which the numeric guard cannot see.  ``:rI``
                 maps lane I's bc to ``2x+1``, ``:neg`` lane 0's to
                 ``-(x+1)``; ``:dI`` (deep) maps lane I's bc to ``2x`` AND
                 recomputes the round's claimed bc sum to match, so only
                 the duplicate vote can catch it.  The ``integrity``
                 audits must detect, quarantine and re-dispatch.
  ``stall``      sleep ``:MS`` milliseconds (default 50) inside the
                 ``at``-th dispatch, through the driver's injectable
                 sleeper — a wedged collective.  Past
                 ``dispatch_deadline_s`` the watchdog must re-dispatch,
                 then escalate to a re-mesh.

A plan is built in code or parsed from the spec of ``--chaos``::

    --chaos "seed=7;transient@1x2;poison@3:nan;kill@4:r1;flip@5;stall@6:200"

entries ``kind@at[xcount][:arg]`` separated by ``;`` or ``,`` (the JAX
package's grammar).

On a grid every rank makes the same dispatch calls with the same inputs,
so the dispatch faults fire on every rank alike, and the outputs poison
and flip change are the ones every rank holds (gathered to all of them).
File faults act where files are written, which on a grid is rank 0
(``core/distributed.py``).
"""
from __future__ import annotations

import dataclasses
import re
import time

import numpy as np
import torch

from ..autotune.cache import CostCache
from .fault_tolerance import ReplicaLostError, TransientRoundError

__all__ = [
    "FAULT_KINDS",
    "DEFAULT_STALL_MS",
    "FaultPlan",
    "FaultEvent",
    "ChaosCrash",
    "ChaosRoundFn",
    "ChaosFS",
    "ChaosCheckpoint",
    "ChaosCostCache",
]

#: the injectable fault classes, the vocabulary of the ``--chaos`` grammar
FAULT_KINDS = ("transient", "poison", "kill", "crash", "torn", "cache", "flip", "stall")

#: the stall of ``stall@K`` without a ``:MS`` argument, milliseconds
DEFAULT_STALL_MS = 50.0

_ENTRY_RE = re.compile(
    r"^(?P<kind>[a-z]+)@(?P<at>\d+)(?:x(?P<count>\d+))?(?::(?P<arg>[A-Za-z0-9_]+))?$"
)


class ChaosCrash(BaseException):
    """Simulated process death (kill-and-resume tests).

    Not an ``Exception``: nothing in the driver — neither the transient
    retry nor the numeric fallback — may swallow it, as with a SIGKILL.
    """


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One declared fault: ``kind`` fires at counter value ``at`` for
    ``count`` consecutive ticks; ``arg`` carries the kind's payload."""

    kind: str
    at: int
    count: int = 1
    arg: str | None = None

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; expected one of {FAULT_KINDS}")
        if self.at < 0 or self.count < 1:
            raise ValueError(f"fault {self.kind!r} needs at >= 0 and count >= 1")
        if self.kind == "poison" and self.arg not in (None, "nan", "inf"):
            raise ValueError(f"poison arg must be 'nan' or 'inf', got {self.arg!r}")
        if self.kind == "kill" and (self.arg is None or not re.fullmatch(r"r\d+", self.arg)):
            raise ValueError(f"kill needs a replica arg like ':r1', got {self.arg!r}")
        if self.kind == "flip" and self.arg is not None and not re.fullmatch(
                r"r\d+|d\d+|neg", self.arg):
            raise ValueError(f"flip arg must be ':rI' (scale lane I), ':dI' (deep: claim fixed "
                             f"up too) or ':neg', got {self.arg!r}")
        if self.kind == "stall" and self.arg is not None and not re.fullmatch(r"\d+", self.arg):
            raise ValueError(f"stall arg is a delay in milliseconds, got {self.arg!r}")

    def covers(self, tick: int) -> bool:
        return self.at <= tick < self.at + self.count


class FaultPlan:
    """Seeded, declarative fault schedule (see the module docstring)."""

    def __init__(self, events: list[FaultEvent] | tuple = (), seed: int = 0):
        self.events = tuple(events)
        self.seed = int(seed)

    @classmethod
    def parse(cls, spec: "str | FaultPlan | None") -> "FaultPlan":
        """Parse a ``--chaos`` spec (a FaultPlan or None passes through)."""
        if spec is None:
            return cls()
        if isinstance(spec, FaultPlan):
            return spec
        seed = 0
        events: list[FaultEvent] = []
        for raw in re.split(r"[;,]", spec):
            entry = raw.strip()
            if not entry:
                continue
            if entry.startswith("seed="):
                seed = int(entry[len("seed="):])
                continue
            m = _ENTRY_RE.match(entry)
            if m is None:
                raise ValueError(f"bad --chaos entry {entry!r}; expected 'kind@at[xcount][:arg]' "
                                 f"with kind in {FAULT_KINDS} (or 'seed=N')")
            events.append(FaultEvent(kind=m["kind"], at=int(m["at"]),
                                     count=int(m["count"] or 1), arg=m["arg"]))
        return cls(events, seed=seed)

    def __repr__(self) -> str:
        parts = [f"seed={self.seed}"] + [
            f"{e.kind}@{e.at}" + (f"x{e.count}" if e.count != 1 else "")
            + (f":{e.arg}" if e.arg is not None else "")
            for e in self.events
        ]
        return f"FaultPlan({';'.join(parts)})"

    def __bool__(self) -> bool:
        return bool(self.events)

    def _of(self, kind: str):
        return (e for e in self.events if e.kind == kind)

    def transient_at(self, call: int) -> bool:
        return any(e.covers(call) for e in self._of("transient"))

    def poison_at(self, call: int) -> str | None:
        for e in self._of("poison"):
            if e.covers(call):
                return e.arg or "nan"
        return None

    def crash_at(self, call: int) -> bool:
        return any(e.covers(call) for e in self._of("crash"))

    def killed_replicas(self, call: int) -> set[int]:
        """Replicas dead as of dispatch ``call`` (a kill has no end:
        ``count`` is ignored)."""
        return {int(e.arg[1:]) for e in self._of("kill") if call >= e.at}

    def flip_at(self, call: int) -> tuple[str, int] | None:
        """``(mode, lane)`` of the finite corruption of dispatch ``call``'s
        output — "scale" (``:rI``, lane 0 by default), "neg" (``:neg``)
        or "deep" (``:dI``, the claim fixed up) — or None."""
        for e in self._of("flip"):
            if e.covers(call):
                arg = e.arg or "r0"
                if arg == "neg":
                    return ("neg", 0)
                return ("deep" if arg[0] == "d" else "scale", int(arg[1:]))
        return None

    def stall_ms(self, call: int) -> float | None:
        """Milliseconds to stall dispatch ``call`` (None: no stall)."""
        for e in self._of("stall"):
            if e.covers(call):
                return float(e.arg) if e.arg is not None else DEFAULT_STALL_MS
        return None

    def torn_save(self, save_idx: int) -> bool:
        return any(e.covers(save_idx) for e in self._of("torn"))

    def corrupt_cache_put(self, put_idx: int) -> bool:
        return any(e.covers(put_idx) for e in self._of("cache"))


class ChaosRoundFn:
    """A driver ``round_fn`` wrapped with the plan's dispatch faults.

    Counts every call (retries too, so ``transient@KxN`` models N
    consecutive failed attempts) and injects in a fixed order: crash,
    replica loss, stall (a sleep through ``sleeper``, before the wrapped
    call), transient raise, then, after the call, poison and flip.
    Replica loss fires only when the dead lane carries live (non-padding)
    columns.
    """

    def __init__(self, round_fn, plan, sleeper=None):
        self.round_fn = round_fn
        self.plan = FaultPlan.parse(plan)
        self.calls = 0
        self._sleep = sleeper if sleeper is not None else time.sleep

    def __call__(self, sources, derived):
        call = self.calls
        self.calls += 1
        if self.plan.crash_at(call):
            raise ChaosCrash(f"chaos: simulated process death at dispatch {call}")
        dead = sorted(self.plan.killed_replicas(call))
        if dead:
            live = (torch.as_tensor(sources) >= 0).any(dim=-1).cpu().numpy()
            for r in dead:
                if r < live.shape[0] and bool(live[r]):
                    raise ReplicaLostError(r, f"chaos: replica {r} lost (dispatch {call})")
        ms = self.plan.stall_ms(call)
        if ms is not None:
            self._sleep(ms / 1000.0)
        if self.plan.transient_at(call):
            raise TransientRoundError(f"chaos: transient round failure at dispatch {call}")
        out = tuple(self.round_fn(sources, derived))
        mode = self.plan.poison_at(call)
        if mode is not None:
            bad = float("nan") if mode == "nan" else float("inf")
            out = (out[0] * bad, out[1] * bad) + out[2:]
        flip = self.plan.flip_at(call)
        if flip is not None:
            out = self._apply_flip(out, *flip)
        return out

    @staticmethod
    def _apply_flip(out: tuple, mode: str, lane: int) -> tuple:
        """Corrupt lane ``lane`` of the block's bc finitely: "scale" →
        ``2x + 1`` (sum and values move: the claim audit or the ABFT
        residual catches it), "neg" → ``-(x + 1)`` (negative values: the
        non-negativity audit's case), "deep" → ``2x`` AND the integrity
        record's claim recomputed from the corrupted lane (corruption
        upstream of the claim: only comparing duplicate lanes finds it)."""
        bc = out[0]
        lanes = bc.shape[0] if bc.dim() > 1 else 1
        if lane >= lanes:
            return out
        upd = {"neg": lambda x: -(x + 1.0), "deep": lambda x: 2.0 * x}.get(
            mode, lambda x: 2.0 * x + 1.0)
        if bc.dim() > 1:
            bc = bc.clone()
            bc[lane] = upd(bc[lane])
        else:
            bc = upd(bc)
        out = (bc,) + out[1:]
        if mode == "deep" and len(out) >= 5 and out[4] is not None:
            integ = out[4].clone()
            if integ.dim() > 1:
                integ[lane, 1] = bc[lane].sum()
            else:
                integ[1] = bc.sum()
            out = out[:4] + (integ,) + out[5:]
        return out


class ChaosFS:
    """The file-write seam: tears or garbles durable files as planned.

    Holds the save / put counters and the seeded generator, so the same
    plan tears the same byte offset every run.  :class:`ChaosCheckpoint`
    and :func:`ChaosCostCache` call back into it after each write.
    """

    def __init__(self, plan):
        self.plan = FaultPlan.parse(plan)
        self._rng = np.random.default_rng(self.plan.seed)
        self.checkpoint_saves = 0
        self.cache_puts = 0
        self.files_corrupted: list[str] = []

    def tear_file(self, path) -> None:
        """Truncate ``path`` at a seeded interior offset: a torn write."""
        path = str(path)
        with open(path, "rb") as f:
            data = f.read()
        cut = max(1, int(len(data) * self._rng.uniform(0.2, 0.8)))
        with open(path, "wb") as f:
            f.write(data[:cut])
        self.files_corrupted.append(path)

    def garble_file(self, path) -> None:
        """Overwrite ``path`` with 64 seeded bytes: unreadable, not short."""
        path = str(path)
        with open(path, "wb") as f:
            f.write(self._rng.bytes(64))
        self.files_corrupted.append(path)

    def after_checkpoint_save(self, path) -> None:
        idx = self.checkpoint_saves
        self.checkpoint_saves += 1
        if self.plan.torn_save(idx):
            self.tear_file(path)

    def after_cache_save(self, path) -> None:
        idx = self.cache_puts
        self.cache_puts += 1
        if self.plan.corrupt_cache_put(idx):
            self.garble_file(path)


class ChaosCheckpoint:
    """A :class:`~repro_torch.checkpoint.BCCheckpoint` proxy that tears
    the snapshot after the saves the plan names (the newest generation,
    which the next resume reads first); everything else is delegated."""

    def __init__(self, inner, fs: ChaosFS):
        self._inner = inner
        self._fs = fs

    def save(self, *args, **kwargs):
        out = self._inner.save(*args, **kwargs)
        self._fs.after_checkpoint_save(self._inner.path)
        return out

    def __getattr__(self, name):
        return getattr(self._inner, name)


def ChaosCostCache(path, fs: ChaosFS) -> CostCache:
    """A :class:`~repro_torch.autotune.cache.CostCache` whose file the plan
    garbles after the puts it names (a ``CostCache`` instance, so the
    planner takes it unchanged)."""

    class _ChaosCostCache(CostCache):
        def save(self):
            super().save()
            if self.path is not None:
                fs.after_cache_save(self.path)

    return _ChaosCostCache(path)

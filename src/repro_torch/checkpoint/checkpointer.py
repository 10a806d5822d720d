"""Durable state: checkpoints of state trees, and the BC round snapshot.

Two checkpoint families live here, each in the JAX package's file format
byte for byte, so that a checkpoint written by one package resumes in
the other:

* :class:`Checkpointer` / :class:`CheckpointManager` — nested dicts of
  tensors (a training state: parameters and optimizer state), one
  directory per step:

      <root>/step_00000100/
          manifest.json      — leaves (key, shape, dtype, logical dtype,
                               sha1), the tree's keys, user metadata
          shard_p0.npz       — every leaf as a host array
          COMMITTED          — the marker, written last

  A leaf's key is its path of dict keys joined with ``/`` (the JAX
  package's key of the same leaf of the same tree).  The directory is
  written as ``.tmp`` and renamed, so a torn write never becomes a
  resume point; restore validates keys, shapes and hashes.

* :class:`BCCheckpoint` — the BC driver's (partial BC, n_s bookkeeping,
  committed rounds) triple, one atomic npz per run, with the committed
  set namespaced per replica ledger.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import queue
import re
import shutil
import threading
from typing import Any

import numpy as np
import torch

__all__ = ["Checkpointer", "CheckpointManager", "BCCheckpoint", "DEFAULT_GENERATIONS"]

log = logging.getLogger(__name__)

_COMMIT = "COMMITTED"

#: BC snapshot generations kept on disk (newest at ``path``, older at
#: ``path.g1``, ``path.g2``, …).  3 balances torn-write survival — one
#: torn newest + one bit-rotted older still leaves an intact resume
#: point — against disk for large-graph partial BC arrays.
DEFAULT_GENERATIONS = 3


def _flatten(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """(key, leaf) pairs of a nested dict, keys joined with ``/``."""
    if isinstance(tree, dict):
        return [kv for k, v in tree.items() for kv in _flatten(v, f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def _unflatten_like(like: Any, leaves: dict[str, Any], prefix: str = "") -> Any:
    if isinstance(like, dict):
        return {k: _unflatten_like(v, leaves, f"{prefix}{k}/") for k, v in like.items()}
    return leaves[prefix[:-1]]


def _host_copy(leaf: Any) -> tuple[np.ndarray, str]:
    """(a host array this checkpoint owns, the leaf's logical dtype).  A
    tensor is copied off its device, or cloned on the CPU (whose
    ``.numpy()`` would share the storage the optimizer keeps updating);
    bfloat16, which npz cannot store, as its raw uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", memory_format=torch.contiguous_format, copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.array(leaf, copy=True)
    return arr, str(arr.dtype)


def _sha1(arr: np.ndarray) -> str:
    return hashlib.sha1(np.ascontiguousarray(arr).tobytes()).hexdigest()


def _to_tensor(arr: np.ndarray, logical: str) -> torch.Tensor:
    if logical == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    if logical != str(arr.dtype):
        raise ValueError(f"cannot restore a {logical} leaf stored as {arr.dtype}")
    return torch.from_numpy(arr)


class Checkpointer:
    """Save/restore nested dicts of tensors; optionally asynchronous.

    ``save`` copies every leaf to host memory of its own before it
    returns (a device tensor is fetched, a CPU tensor cloned), so the
    caller may go on updating the state in place while an asynchronous
    write drains.  ``restore`` returns CPU tensors in the structure of
    ``like``."""

    def __init__(self, root: str, async_writes: bool = False):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._async = async_writes
        self._queue: queue.Queue | None = None
        self._worker: threading.Thread | None = None
        self._errors: list[Exception] = []
        if async_writes:
            self._queue = queue.Queue()
            self._worker = threading.Thread(target=self._drain, daemon=True)
            self._worker.start()

    # ------------------------------------------------------------- write
    def _drain(self):
        while True:
            item = self._queue.get()
            if item is None:
                return
            try:
                self._write(*item)
            except Exception as e:  # surfaced on wait()
                self._errors.append(e)
            finally:
                self._queue.task_done()

    def step_dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:08d}")

    def save(self, step: int, state: Any, metadata: dict | None = None) -> str:
        """Snapshot ``state`` (host copies first, so the caller can keep
        training while an async write drains)."""
        leaves = _flatten(state)
        host = [(key, *_host_copy(leaf)) for key, leaf in leaves]
        treedef = "nested dict: " + ", ".join(key for key, _ in leaves)
        if self._async:
            self._queue.put((step, host, treedef, metadata or {}))
        else:
            self._write(step, host, treedef, metadata or {})
        return self.step_dir(step)

    def _write(self, step, host_leaves, treedef_str, metadata):
        d = self.step_dir(step)
        tmp = d + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        arrays = {}
        entries = []
        for key, arr, logical_dtype in host_leaves:
            arrays[key] = arr
            entries.append({
                "key": key,
                "shape": list(arr.shape),
                "dtype": str(arr.dtype),
                "logical_dtype": logical_dtype,
                "sha1": _sha1(arr),
            })
        np.savez(os.path.join(tmp, "shard_p0.npz"), **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "treedef": treedef_str, "leaves": entries,
                       "metadata": metadata}, f, indent=1)
        with open(os.path.join(tmp, _COMMIT), "w") as f:
            f.write("ok")
        if os.path.exists(d):
            shutil.rmtree(d)
        os.replace(tmp, d)

    def wait(self) -> None:
        """Block until pending async writes land (re-raises failures)."""
        if self._queue is not None:
            self._queue.join()
        if self._errors:
            raise self._errors[0]

    def close(self) -> None:
        """Shut the worker down even when a queued write failed: wait()
        re-raises the write error, so the sentinel/join must run on the
        way out or the writer thread leaks past close()."""
        if self._queue is None:
            return
        try:
            self.wait()
        finally:
            self._queue.put(None)
            self._worker.join()

    # -------------------------------------------------------------- read
    def available_steps(self) -> list[int]:
        steps = []
        if not os.path.isdir(self.root):
            return steps
        for name in os.listdir(self.root):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.root, name, _COMMIT)):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def restore(self, like: Any, step: int | None = None) -> tuple[Any, dict]:
        """Restore into the structure of ``like`` (validates keys, shapes
        and hashes): (state of CPU tensors, metadata)."""
        steps = self.available_steps()
        if not steps:
            raise FileNotFoundError(f"no committed checkpoints under {self.root}")
        step = steps[-1] if step is None else step
        d = self.step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(d, "shard_p0.npz")) as z:
            arrays = {k: z[k] for k in z.files}
        by_key = {e["key"]: e for e in manifest["leaves"]}
        for key, arr in arrays.items():
            if by_key[key]["sha1"] != _sha1(arr):
                raise IOError(f"checkpoint corruption in {key} at step {step}")
        restored = {}
        for key, leaf in _flatten(like):
            if key not in arrays:
                raise KeyError(f"checkpoint missing leaf {key}")
            arr = arrays[key]
            t = _to_tensor(arr, by_key[key].get("logical_dtype", by_key[key]["dtype"]))
            want_shape = tuple(getattr(leaf, "shape", t.shape))
            if tuple(t.shape) != want_shape:
                raise ValueError(f"shape mismatch for {key}: ckpt {tuple(t.shape)} vs "
                                 f"{want_shape}")
            restored[key] = t
        return _unflatten_like(like, restored), manifest["metadata"]


class CheckpointManager:
    """Retention + auto-resume policy on top of Checkpointer."""

    def __init__(self, root: str, keep_last: int = 3, save_every: int = 100,
                 async_writes: bool = False):
        self.ckpt = Checkpointer(root, async_writes=async_writes)
        self.keep_last = keep_last
        self.save_every = save_every

    def maybe_save(self, step: int, state: Any, metadata: dict | None = None) -> bool:
        if step % self.save_every != 0:
            return False
        self.ckpt.save(step, state, metadata)
        self.ckpt.wait()
        self._gc()
        return True

    def _gc(self) -> None:
        steps = self.ckpt.available_steps()
        for s in steps[: -self.keep_last]:
            shutil.rmtree(self.ckpt.step_dir(s))

    def latest_step(self) -> int | None:
        steps = self.ckpt.available_steps()
        return steps[-1] if steps else None

    def restore_or_init(self, init_state: Any) -> tuple[Any, dict, int]:
        """(state, metadata, start_step) — exact resume when possible."""
        step = self.latest_step()
        if step is None:
            return init_state, {}, 0
        state, meta = self.ckpt.restore(init_state, step)
        return state, meta, step + 1


class BCCheckpoint:
    """Durable (partial BC, n_s bookkeeping, committed rounds) triple.

    A ledger alone is not enough to resume BC: the committed rounds'
    *contributions* live in the (volatile) device accumulator.  The
    shared round loop (:class:`repro_torch.core.driver.BCDriver`) therefore
    periodically snapshots a consistent prefix — the drained rounds'
    summed BC, their per-root component sizes, and exactly that round
    set — through this object; a restarted run seeds the driver from the
    snapshot and re-deals only the uncommitted rounds.  Consistency
    invariant: the stored bc/ns always correspond exactly to the stored
    committed set (snapshots happen only after the in-flight queue is
    fully drained), so a crash between snapshots merely redoes the tail.
    The stored bc is correction-free (the 1-degree analytic credits are
    pure post-processing and are re-applied on every finalize).

    Round ids are only meaningful relative to one schedule, so every
    snapshot carries a schedule fingerprint (see
    :func:`repro_torch.distributed.fault_tolerance.schedule_fingerprint`);
    resuming against a different schedule — other graph, batch size or
    heuristics — raises instead of silently mixing incompatible partial
    sums.

    **Ledger namespacing.**  Under the multi-ledger straggler scheduler
    each replica commits into its own ledger; ``save`` accepts either a
    flat committed list (one shared ledger) or a list of per-replica
    lists, stored as ``committed_r{i}`` alongside the merged union under
    the legacy ``committed`` key.  :meth:`load` returns the union — a
    round committed by *any* replica (including one that stole or was
    re-dealt the round before the kill) is never re-accumulated — while
    :meth:`load_namespaced` returns the per-replica sets so a resumed
    multi-ledger driver keeps its commit attribution.  The straggler
    policy and replica count may differ across the resume: exactly-once
    only needs the union.

    **Generations & integrity.**  A single snapshot file makes a torn
    write (kill mid-flush, disk full) total loss, so ``save`` rotates
    the last ``generations`` snapshots — newest always at ``path``
    (legacy layout), older shifted to ``path.g1``, ``path.g2``, … —
    and embeds a per-array sha1 manifest (the JAX package's
    ``Checkpointer`` scheme).  ``load`` walks newest →
    oldest, validates hashes, and resumes from the first intact
    generation with a logged warning for every one it skips; only when
    *every* generation is gone/corrupt does it cold-start (again warned,
    never a traceback).  :attr:`loaded_generation` records which one the
    last load used (0 = newest, None = cold start) so the driver can
    report it in ``BCResult.recovery_stats``.  A *readable* snapshot
    whose fingerprint mismatches still raises ValueError — that is a
    configuration error, not corruption, and older generations would
    only mask it.
    """

    def __init__(self, path: str, generations: int = DEFAULT_GENERATIONS):
        self.path = path
        self.generations = max(1, int(generations))
        #: generation index the last load() resumed from (None = cold).
        self.loaded_generation: int | None = None
        #: recovery-telemetry dict the last load() found in the snapshot
        #: (None when absent) — the driver resumes its counters from it
        #: so retry/quarantine/re-mesh history survives kill-and-resume.
        self.loaded_stats: dict | None = None

    def generation_paths(self) -> list[str]:
        """Snapshot paths newest → oldest (``path``, ``path.g1``, …)."""
        return [self.path] + [
            f"{self.path}.g{i}" for i in range(1, self.generations)
        ]

    def exists(self) -> bool:
        return any(os.path.exists(p) for p in self.generation_paths())

    def _read_validated(self, path: str) -> dict:
        """Load one snapshot file and verify its manifest hashes.

        Raises (IOError or whatever np.load raises) on torn/garbled
        files; pre-generational snapshots carry no manifest and are
        accepted as-is for compatibility.
        """
        with np.load(path, allow_pickle=False) as z:
            arrays = {k: z[k] for k in z.files}
        missing = [
            k for k in ("bc", "ns_roots", "ns_vals", "fingerprint")
            if k not in arrays
        ]
        if missing:
            raise IOError(f"snapshot {path} missing arrays {missing}")
        if "manifest" in arrays:
            manifest = json.loads(str(arrays["manifest"]))
            for key, want in manifest["sha1"].items():
                if key not in arrays:
                    raise IOError(
                        f"snapshot {path} missing array {key!r} named in manifest"
                    )
                got = hashlib.sha1(
                    np.ascontiguousarray(arrays[key]).tobytes()
                ).hexdigest()
                if got != want:
                    raise IOError(f"snapshot {path}: sha1 mismatch in {key!r}")
        return arrays

    def load(self, expected_fingerprint: str | None = None):
        """Returns (bc f64 [n] | None, ns_by_root dict, committed list).

        ``committed`` is the union over all replica ledgers.  Raises
        ValueError when the snapshot was written for a different schedule
        than ``expected_fingerprint``.
        """
        bc, ns_by_root, by_ledger = self.load_namespaced(expected_fingerprint)
        return bc, ns_by_root, sorted({r for lane in by_ledger for r in lane})

    def load_namespaced(self, expected_fingerprint: str | None = None):
        """Returns (bc | None, ns_by_root, committed_by_ledger).

        ``committed_by_ledger`` is a list of per-replica committed-round
        lists; a snapshot written by the single-ledger loop loads as one
        ledger.  Same fingerprint semantics as :meth:`load`.  Walks the
        generations newest → oldest past corrupt files (warned, never
        raised); an empty/unrecoverable state returns the cold-start
        triple ``(None, {}, [])``.
        """
        self.loaded_generation = None
        self.loaded_stats = None
        candidates = [
            (gen, p)
            for gen, p in enumerate(self.generation_paths())
            if os.path.exists(p)
        ]
        if not candidates:
            return None, {}, []
        for gen, p in candidates:
            try:
                arrays = self._read_validated(p)
            except Exception as e:
                log.warning(
                    "BCCheckpoint: snapshot %s unreadable (%s: %s); "
                    "falling back to an older generation",
                    p, type(e).__name__, e,
                )
                continue
            stored = str(arrays["fingerprint"])
            if expected_fingerprint is not None and stored != expected_fingerprint:
                raise ValueError(
                    f"checkpoint {p} was written for a different "
                    f"schedule (stored {stored}, expected "
                    f"{expected_fingerprint}) — same graph, batch size and "
                    f"heuristics are required to resume"
                )
            bc = arrays["bc"].astype(np.float64)
            ns_by_root = {
                int(r): float(v)
                for r, v in zip(arrays["ns_roots"], arrays["ns_vals"])
            }
            if "ledger_count" in arrays:
                by_ledger = [
                    [int(r) for r in arrays[f"committed_r{i}"]]
                    for i in range(int(arrays["ledger_count"]))
                ]
            else:  # legacy single-ledger snapshot
                by_ledger = [[int(r) for r in arrays["committed"]]]
            if "recovery_stats" in arrays:
                try:
                    self.loaded_stats = json.loads(str(arrays["recovery_stats"]))
                except Exception:  # telemetry is advisory, never fatal
                    self.loaded_stats = None
            self.loaded_generation = gen
            if gen > 0:
                log.warning(
                    "BCCheckpoint: resumed from generation %d (%s); newer "
                    "snapshots were corrupt", gen, p,
                )
            return bc, ns_by_root, by_ledger
        log.warning(
            "BCCheckpoint: no intact snapshot generation at %s; cold start",
            self.path,
        )
        return None, {}, []

    def save(
        self, bc, ns_by_root: dict, committed, fingerprint: str,
        *, stats: dict | None = None,
    ) -> None:
        """``committed``: flat list[int] (one ledger) or list of per-replica
        lists (multi-ledger).  ``stats`` (optional) is a JSON-serializable
        recovery-telemetry dict stored under the manifest's hash cover so
        the driver's counters survive kill-and-resume.  Writes atomically
        (tmp + rename) and rotates the previous snapshots one generation
        older."""
        roots = np.asarray(sorted(ns_by_root), np.int64)
        vals = np.asarray([ns_by_root[int(r)] for r in roots], np.float64)
        committed = list(committed)
        nested = bool(committed) and isinstance(
            committed[0], (list, tuple, np.ndarray)
        )
        by_ledger = (
            [[int(r) for r in lane] for lane in committed]
            if nested
            else [[int(r) for r in committed]]
        )
        union = sorted({rid for lane in by_ledger for rid in lane})
        arrays = {
            "bc": np.asarray(bc, np.float64),
            "ns_roots": roots,
            "ns_vals": vals,
            "committed": np.asarray(union, np.int64),
            "fingerprint": np.asarray(fingerprint),
            "ledger_count": np.asarray(len(by_ledger), np.int64),
        }
        for i, lane in enumerate(by_ledger):
            arrays[f"committed_r{i}"] = np.asarray(sorted(lane), np.int64)
        if stats is not None:
            arrays["recovery_stats"] = np.asarray(json.dumps(stats))
        arrays["manifest"] = np.asarray(
            json.dumps(
                {
                    "sha1": {
                        k: hashlib.sha1(
                            np.ascontiguousarray(v).tobytes()
                        ).hexdigest()
                        for k, v in arrays.items()
                    }
                }
            )
        )
        tmp = f"{self.path}.tmp.npz"
        np.savez(tmp, **arrays)
        # rotate oldest-first so each os.replace lands on a free slot
        gens = self.generation_paths()
        for newer, older in zip(gens[-2::-1], gens[:0:-1]):
            if os.path.exists(newer):
                os.replace(newer, older)
        os.replace(tmp, self.path)

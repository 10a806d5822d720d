"""Host-side prefetching: overlap batch construction with device steps.

A copy of the JAX package's ``data/pipeline.py``: one producer thread
and a bounded queue.  The batches stay what the producer makes (numpy
arrays); moving them to the card is the consumer's step.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable

__all__ = ["Prefetcher"]


class Prefetcher:
    """Runs ``producer(step)`` in a background thread, ``depth`` ahead."""

    def __init__(self, producer: Callable[[int], object], depth: int = 2, start_step: int = 0):
        self.producer = producer
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            try:
                item = (step, self.producer(step))
            except Exception as e:  # surface in get()
                self._q.put((step, e))
                return
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def get(self):
        step, item = self._q.get()
        if isinstance(item, Exception):
            raise item
        return step, item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)

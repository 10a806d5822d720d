"""Deterministic synthetic LM token stream with an exact-resume cursor.

A copy of the JAX package's ``data/tokens.py`` (numpy, no device): the
same seed and step give the same batch, bit for bit, in both packages.
Tokens follow a seeded order-0 Markov-ish mixture (so a training loss
actually decreases, unlike on uniform noise).  The stream is a pure
function of (seed, step), so resuming from a checkpoint at step k
reproduces exactly the batches a non-interrupted run would have seen.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["TokenStream"]


@dataclasses.dataclass
class TokenStream:
    vocab: int
    batch: int
    seq_len: int
    seed: int = 0
    n_modes: int = 32

    def batch_at(self, step: int) -> np.ndarray:
        """i32 [batch, seq_len] — pure function of (seed, step)."""
        rng = np.random.default_rng((self.seed << 20) ^ step)
        # each sequence draws from a small per-sequence token set → learnable
        modes = rng.integers(0, self.n_modes, size=(self.batch, 1))
        base = (modes * 97 + 13) % max(self.vocab - 64, 1)
        offsets = rng.integers(0, 64, size=(self.batch, self.seq_len))
        return ((base + offsets) % self.vocab).astype(np.int32)

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1

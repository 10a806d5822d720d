"""The general traffic generator: which rounds of the program's schedule
the window runs, and in what order, from a mix's data file and the seed.

A mix (``bench/traffic/<name>.json``) names:

* ``pool_rounds`` P: the window draws from P rounds spread evenly over
  the schedule (round ⌊i·N/P⌋ for i < P of N), so every seed runs the
  same set of rounds and a window's work does not depend on the seed;
``--seed`` picks the pool position the window starts at; from there the
rounds follow in schedule order, round the pool, in whole passes: every
seed runs the same rounds, in another order.
"""
from __future__ import annotations

import numpy as np

__all__ = ["pool", "round_order"]


def pool(n_rounds: int, spec: dict) -> list[int]:
    """The schedule indices of the mix's pool, in schedule order."""
    p = min(int(spec["pool_rounds"]), n_rounds)
    if p < 1:
        raise ValueError("the schedule has no round to run")
    return [i * n_rounds // p for i in range(p)]


def round_order(n_rounds: int, spec: dict, seed: int, passes: int = 1) -> list[int]:
    """The window's rounds: ``passes`` passes over the pool from a seeded
    start."""
    rounds = pool(n_rounds, spec)
    start = int(np.random.default_rng(seed % (1 << 64)).integers(len(rounds)))
    return [rounds[(start + i) % len(rounds)] for i in range(passes * len(rounds))]

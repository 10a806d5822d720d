"""Synthetic click-log batches for the DLRM cells (deterministic).

A copy of the JAX package's ``data/recsys.py``: the same ``(cfg, batch,
seed, step)`` gives byte-identical numpy arrays in both packages.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..configs.base import DLRMArch

__all__ = ["ClickLogStream"]


@dataclasses.dataclass
class ClickLogStream:
    cfg: DLRMArch
    batch: int
    seed: int = 0

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed << 20) ^ step)
        cfg = self.cfg
        dense = rng.standard_normal((self.batch, cfg.n_dense)).astype(np.float32)
        # zipf-ish sparse ids (hot rows dominate, like real logs)
        raw = rng.zipf(1.2, size=(self.batch, cfg.n_sparse, cfg.hot_size))
        sparse = ((raw - 1) % cfg.rows_per_table).astype(np.int32)
        # clickiness correlated with a linear probe of dense features
        p = 1.0 / (1.0 + np.exp(-(dense[:, :4].sum(axis=1))))
        labels = (rng.random(self.batch) < p).astype(np.float32)
        return {"dense": dense, "sparse": sparse, "labels": labels}

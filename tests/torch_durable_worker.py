"""Rank-side case runner for tests/test_torch_durable.py's 2-D cases.

``run_cases`` is what each spawned gloo rank executes
(:func:`repro_torch.distributed.run_gloo` pickles it by reference).  It
imports only numpy, torch and the port — never jax or the JAX package.
Every rank runs the same cases in the same order, as the collectives
require; the checkpoints live under ``tmpdir``, shared by the ranks.
"""
from __future__ import annotations

import os

from repro_torch.core.distributed import distributed_betweenness_centrality
from repro_torch.distributed import BCCheckpoint
from repro_torch.graphs import gnp_graph, rmat_graph
from repro_torch.serving import AdaptiveStopRule, BlockBudgetStop

#: the graph and sampled schedule of the resume cases (tests/test_sampling.py's)
SAMPLED_GRAPH = dict(n=36, p=0.15, seed=6)
SAMPLED = dict(heuristics="h0", batch_size=4, sampling="fixed", sample_k=12, sample_seed=5)


def _run(groups, graph, **kw):
    res = distributed_betweenness_centrality(graph, groups, device="cpu", full_result=True, **kw)
    return {"bc": res.bc, "rounds_run": res.rounds_run, "stopped_early": res.stopped_early,
            "roots": res.roots_accumulated, "stop_stats": res.stop_stats,
            "resumed_generation": res.recovery_stats["resumed_generation"]}


def run_cases(groups, tmpdir: str) -> dict:
    g = gnp_graph(**SAMPLED_GRAPH)
    ckpt = lambda name: BCCheckpoint(os.path.join(tmpdir, name))  # noqa: E731
    out = {"rank": groups.rank}
    # kill and resume: a run stopped after one block, then a fresh call
    out["partial"] = _run(groups, g, checkpoint=ckpt("resume.npz"),
                          stop_rule=BlockBudgetStop(1), **SAMPLED)
    out["resumed"] = _run(groups, g, checkpoint=ckpt("resume.npz"), **SAMPLED)
    out["uninterrupted"] = _run(groups, g, **SAMPLED)
    # a partial snapshot the JAX package wrote before the ranks started
    out["from_jax"] = _run(groups, g, checkpoint=ckpt("jax.npz"), **SAMPLED)
    # a partial snapshot for the JAX package to resume (rank 0 writes it)
    out["for_jax"] = _run(groups, g, checkpoint=ckpt("torch.npz"),
                          stop_rule=BlockBudgetStop(2), **SAMPLED)
    # exact h3 on a fresh checkpoint: one snapshot, every round committed
    out["exact"] = _run(groups, gnp_graph(30, 0.15, seed=13), batch_size=4, heuristics="h3",
                        checkpoint=ckpt("exact.npz"))
    # adaptive sampling: every rank stops at rank 0's block
    out["adaptive"] = _run(groups, rmat_graph(8, 8, seed=3), batch_size=8, heuristics="h0",
                           sampling="adaptive",
                           stop_rule=AdaptiveStopRule(top_k=10, window=3, min_blocks=3))
    return out

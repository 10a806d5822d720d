"""The port's roofline terms (roofline/model.py) and its work and
collective counter (roofline/counter.py) against the JAX package.

The terms (``link_bytes``, ``ring_steps``, ``ring_latency_s``,
``roofline_terms``) are held to the JAX package's on hypothesis-drawn
collective records, priced with the JAX package's V5E rates built into a
port ``HardwareSpec`` (the port holds no TPU constant).  The counter is
held to ``BENCH_overlap.json``, which benchmarks/fig9_overlap.py wrote
from the JAX package's compiled HLO of one round (rmat_graph(8, 8,
seed=0), build_schedule(batch_size=16), 2x4 mesh, num_levels=12): the
port runs the same round on a spawned 2x4 gloo grid under a
``WorkCounter``, and every difference between the two is named below
with its cause and subtracted, per class and per round.
"""
import dataclasses
import json
import pathlib

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.roofline import model as jmodel
from repro_torch.distributed import run_gloo
from repro_torch.roofline import counter as work
from repro_torch.roofline import model as pmodel
import torch_cells_worker

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCH_overlap.json").read_text())
#: the JAX package's V5E rates, as a port HardwareSpec
V5E = pmodel.HardwareSpec(
    name=jmodel.V5E.name,
    peak_flops=jmodel.V5E.peak_bf16_flops,
    hbm_bandwidth=jmodel.V5E.hbm_bandwidth,
    link_bandwidth=jmodel.V5E.ici_link_bandwidth,
    hop_latency_s=jmodel.V5E.ici_step_latency_s,
)
CLASSES = ("all-gather", "reduce-scatter", "all-reduce", "all-to-all", "collective-permute",
           "collective-broadcast")

records = st.lists(st.fixed_dictionaries(
    {"class": st.sampled_from(CLASSES),
     "operand_bytes": st.floats(0, 1e10, allow_nan=False)},
    optional={"group_size": st.integers(0, 64), "count": st.integers(0, 200)},
), max_size=12)


@settings(max_examples=200, deadline=None)
@given(recs=records)
def test_link_bytes_and_ring_steps_match_jax(recs):
    assert pmodel.link_bytes(recs) == jmodel.link_bytes(recs)
    assert pmodel.ring_steps(recs) == jmodel.ring_steps(recs)
    assert pmodel.ring_latency_s(recs, hw=V5E) == jmodel.ring_latency_s(recs, hw=jmodel.V5E)


@settings(max_examples=200, deadline=None)
@given(recs=records, flops=st.floats(0, 1e15, allow_nan=False),
       nbytes=st.floats(0, 1e13, allow_nan=False), devices=st.integers(1, 64),
       model_flops=st.floats(0, 1e16, allow_nan=False))
def test_roofline_terms_match_jax(recs, flops, nbytes, devices, model_flops):
    terms = {"flops": flops, "bytes": nbytes, "collectives": recs}
    got = pmodel.roofline_terms(terms, devices, model_flops, hw=V5E)
    want = jmodel.roofline_terms(terms, devices, model_flops, hw=jmodel.V5E)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.step_time_s == want.step_time_s
    assert got.roofline_fraction == want.roofline_fraction


def test_h100_terms_price_with_the_h100_rates():
    recs = [{"class": "all-gather", "operand_bytes": 1e6, "group_size": 4, "count": 3}]
    rt = pmodel.roofline_terms({"flops": 67e12, "bytes": 3.35e12, "collectives": recs}, 1)
    assert rt.compute_s == 1.0 and rt.memory_s == 1.0
    assert rt.collective_s == 3e6 / 450e9 and rt.ring_steps == 9
    assert rt.ring_latency_s == 9 * pmodel.H100.hop_latency_s


# --------------------------------------------------------------- counter
POLICIES = ("none", "expand", "expand+fold")
#: port engine -> the JAX engine of BENCH_overlap.json
BENCH_ENGINE = {"sparse": "sparse", "fused": "pallas"}
NUM_LEVELS = BENCH["num_levels"]


@pytest.fixture(scope="module")
def counted():
    cases = [(f"{e}-{p}", "counted", (e, p, NUM_LEVELS)) for e in BENCH_ENGINE for p in POLICIES]
    return run_gloo(torch_cells_worker.run_cases, 1, 2, 4, (cases,), timeout_s=300)


def _record(cls, operand_bytes, group_size, count=1):
    return {"class": cls, "operand_bytes": float(operand_bytes), "group_size": group_size,
            "count": count}


def _named_differences(engine_kind: str, overlap: str, chunk: int, s: int, k: int) -> list[dict]:
    """What the port's round issues beyond the collectives of the JAX
    package's compiled round, as records:

    1. the end-of-round gathers: the port returns every output on every
       rank (the BC in vertex order over the 8-rank world, [chunk] f32;
       ns f32 [s+k], roots i32 [s+k] and levels i32 [1] over the fr = 1
       replica group), where the JAX round leaves them sharded;
    2. ``forward_counting``'s static-path max-depth all-reduce (i32, over
       the 8-rank grid): the round reads the grid max of the derived
       columns' depths instead, so XLA drops it as dead code;
    3. fused engines only: the backward level's σ, d and ω exchanges.
       They do not change during the sweep; XLA hoists them out of its
       while loop (sent once a round), the eager port sends them every
       one of the NUM_LEVELS − 1 backward levels — NUM_LEVELS − 2
       times more each ([chunk, s+k] f32 σ, [chunk, s+k] i32 d,
       [chunk] f32 ω), as all-gathers over the 2-rank column group or,
       under a ring, as R − 1 = 1 hop each.
    """
    w = s + k
    diff = [_record("all-gather", chunk * 4, 8),
            _record("all-gather", w * 4, 1), _record("all-gather", w * 4, 1),
            _record("all-gather", 4, 1),
            _record("all-reduce", 4, 8)]
    if engine_kind == "fused":
        extra = (NUM_LEVELS - 2) * (chunk * w * 4 * 2 + chunk * 4)
        count = 3 * (NUM_LEVELS - 2)
        if overlap == "none":
            diff.append(_record("all-gather", extra, 2, count))
        else:
            diff.append(_record("collective-permute", extra, 1, count))
    return diff


def _by_class(recs) -> dict:
    out = {cls: 0 for cls in ("all-gather", "reduce-scatter", "all-reduce", "collective-permute")}
    for rec in recs:
        out[rec["class"]] += rec.get("count", 1)
    return out


@pytest.mark.parametrize("overlap", POLICIES)
@pytest.mark.parametrize("engine_kind", sorted(BENCH_ENGINE))
def test_counter_reproduces_the_jax_hlo_collectives(counted, engine_kind, overlap):
    want = BENCH["engines"][BENCH_ENGINE[engine_kind]][overlap]
    chunk, s, k = 256 // 8, 16, 8
    for rank in counted:  # every rank issues the same collectives
        got = rank[f"{engine_kind}-{overlap}"]
        recs = got["terms"]["collectives"]
        diff = _named_differences(engine_kind, overlap, chunk, s, k)
        have, named = _by_class(recs), _by_class(diff)
        assert {c: have[c] - named[c] for c in have} == want["collectives_per_round_by_class"]
        assert sum(have.values()) - sum(named.values()) == want["collectives_per_round"]
        assert (pmodel.link_bytes(recs) - pmodel.link_bytes(diff)
                == pytest.approx(want["link_bytes_per_round"], rel=1e-12))
        assert (pmodel.ring_steps(recs) - pmodel.ring_steps(diff)
                == want["ring_steps_per_round"])


@pytest.mark.parametrize("overlap", POLICIES)
@pytest.mark.parametrize("engine_kind", sorted(BENCH_ENGINE))
def test_counter_files_each_collective_under_its_group(counted, engine_kind, overlap):
    """The level loop's expands run over the column group, its folds over
    the row group, the agreements over the grid; the end-of-round gathers
    over the world and the replica group.  A ring hop is one record whose
    ``count`` is the tensors it sends."""
    recs = counted[0][f"{engine_kind}-{overlap}"]["records"]
    where = {(r["class"], r["group"]) for r in recs}
    assert ("all-reduce", "grid") in where and ("all-gather", "world") in where
    assert ("all-gather", "replica") in where
    hops = [r for r in recs if r["class"] == "collective-permute"]
    expands = [r for r in recs if r["group"] == "column"]
    folds = [r for r in recs if r["group"] == "row"]
    levels = 2 * NUM_LEVELS - 1
    assert len(expands) == (levels if engine_kind == "sparse" or overlap != "none"
                            else 2 * NUM_LEVELS + 4 * (NUM_LEVELS - 1))
    assert all(r["class"] == ("all-gather" if overlap == "none" else "collective-permute")
               for r in expands)
    if overlap == "expand+fold":
        assert len(folds) == 3 * levels and all(r["class"] == "collective-permute" for r in folds)
    else:
        assert len(folds) == levels and all(r["class"] == "reduce-scatter" for r in folds)
    tensors = {"sparse": {1}, "fused": {2, 4}}[engine_kind] if overlap != "none" else set()
    assert {r["count"] for r in hops if r["group"] == "column"} == tensors


@pytest.mark.parametrize("engine_kind", sorted(BENCH_ENGINE))
def test_counter_reports_the_level_products(counted, engine_kind):
    """The products of the static round: 12 forward and 11 backward level
    steps, each with the FLOP and bytes of the shared formulas."""
    got = counted[0][f"{engine_kind}-none"]
    by_name = got["by_name"]
    fwd, bwd = NUM_LEVELS, NUM_LEVELS - 1
    if engine_kind == "sparse":
        assert by_name["arc_gather"]["calls"] == by_name["arc_sum"]["calls"] == fwd + bwd
        assert by_name["arc_gather"]["flops"] == 0.0
    else:
        assert by_name["frontier_spmm_partial"]["calls"] == fwd
        assert by_name["dependency_spmm_partial"]["calls"] == bwd
        # the [C·chunk, R·chunk] = [128, 64] block at s = 16 forward, 24 backward
        assert by_name["frontier_spmm_partial"]["flops"] == fwd * work.dense_flops(128, 64, 16)
        assert by_name["dependency_spmm_partial"]["flops"] == bwd * work.dense_flops(128, 64, 24)
    terms = got["terms"]
    assert terms["flops"] == sum(v["flops"] for v in by_name.values()) > 0
    assert terms["bytes"] == sum(v["bytes"] for v in by_name.values()) > 0


def test_counter_records_nothing_when_inactive(counted):
    for rank in counted:
        for case in rank.values():
            assert case["idle"] == ([], [])
    assert work.ACTIVE is None
    with work.WorkCounter() as c:
        assert work.ACTIVE is c
        with pytest.raises(RuntimeError, match="already active"):
            work.WorkCounter().__enter__()
    assert work.ACTIVE is None


def test_work_formulas():
    import torch

    from repro_torch.kernels import ops

    rng = np.random.default_rng(0)
    a = torch.from_numpy((rng.random((6, 5)) < 0.5).astype(np.float32))
    sigma = torch.from_numpy(rng.integers(0, 3, (5, 4)).astype(np.float32))
    depth = torch.from_numpy(rng.integers(-1, 3, (5, 4)).astype(np.int32))
    delta, omega = torch.zeros(5, 4), torch.zeros(5)
    assert work.partial_bytes(a, sigma, depth) == a.nbytes + sigma.nbytes + depth.nbytes + 6 * 16
    with work.WorkCounter() as c:
        ops.frontier_spmm_partial(a, sigma, depth, 1)
        ops.dependency_spmm_partial(a, sigma, depth, delta, omega, 1)
        table = torch.ones(10, 3)
        ids = torch.tensor([[1, 1, -1], [2, 9, 1]], dtype=torch.int32)
        ops.segment_bag(table, ids)
    got = c.by_name()
    assert got["frontier_spmm_partial"] == {"calls": 1, "flops": 2.0 * 6 * 5 * 4,
                                            "bytes": float(work.partial_bytes(a, sigma, depth))}
    assert got["dependency_spmm_partial"]["bytes"] == work.partial_bytes(a, sigma, depth, delta,
                                                                         omega)
    # 3 distinct rows of 3 f32, 6 ids, a [2, 3] f32 output
    assert got["segment_bag"] == {"calls": 1, "flops": 2.0 * 6 * 3,
                                  "bytes": float(3 * 3 * 4 + 6 * 4 + 2 * 3 * 4)}
    x, idx = torch.ones(7, 4), torch.tensor([0, 3, 3], dtype=torch.int64)
    assert work.gather_bytes(x, idx) == 7 * 16 + 3 * 8 + 3 * 16


@pytest.mark.parametrize("pass_bytes", [0, 1 << 30], ids=["four-passes", "one-pass"])
@pytest.mark.parametrize("piece", [3, 256])
@pytest.mark.parametrize("acc", ["float32", "float64"])
def test_arc_product_counts_its_work_at_the_operand_width(monkeypatch, acc, piece, pass_bytes):
    """The arc product's counted bytes are the f32 work of the function
    (x and the ids read, the [arcs, s] messages written then read, the
    [rows, s] sums written), whatever width it accumulates in; its sums,
    in one pass or four column passes, rows cut into pieces of 3 arcs or
    whole, are the row sums at that width, and the same bits every call."""
    import torch

    from repro_torch.core import operators

    monkeypatch.setattr(operators, "_ARC_ACC", getattr(torch, acc))
    monkeypatch.setattr(operators, "_ARC_PIECE", piece)
    monkeypatch.setattr(operators, "_ARC_PASS_BYTES", pass_bytes)
    rng = np.random.default_rng(3)
    rows, arcs, s = 9, 40, 7
    dst = torch.from_numpy(rng.integers(0, rows + 1, arcs))
    src = torch.from_numpy(rng.integers(0, rows, arcs))
    src, dst, _, lengths = operators._by_destination(src, dst, None, rows)
    pieces, counts = operators._arc_pieces(lengths)
    if piece == 256:  # no row is longer than a piece: one level of sums
        assert pieces is None and counts is lengths
    else:
        assert pieces.max() <= 3 and int(pieces.sum()) == arcs
        per_row = torch.zeros_like(lengths).index_add_(
            0, torch.repeat_interleave(torch.arange(rows + 1), counts), pieces)
        assert torch.equal(per_row, lengths)
    x = torch.from_numpy(rng.standard_normal((rows, s)).astype(np.float32))
    with work.WorkCounter() as c:
        got = operators._arc_product(x, src, pieces, counts, rows)
    msgs = arcs * s * 4
    assert c.by_name() == {
        "arc_gather": {"calls": 1, "flops": 0.0, "bytes": float(x.nbytes + src.nbytes + msgs)},
        "arc_sum": {"calls": 1, "flops": 2.0 * arcs * s,
                    "bytes": float(msgs + (rows + 1) * 8 + rows * s * 4)},
    }
    want = np.zeros((rows + 1, s))
    np.add.at(want, dst.numpy(), x.numpy().astype(np.float64)[src.numpy()])
    tol = 1e-7 if acc == "float64" else 1e-5  # f64: one f32 rounding
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want[:rows], rtol=tol, atol=tol)
    assert torch.equal(got, operators._arc_product(x, src, pieces, counts, rows))

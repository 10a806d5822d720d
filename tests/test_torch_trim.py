"""``BCDriver`` ships only the derived slots a dispatch block uses: the
block's ``derived [fr, k, 3]`` cut to ``[fr, w, 3]``, ``w`` one past the
last slot with a root in any lane.  Each run here is held to the same
schedule dispatched untrimmed (``_shipped_derived`` replaced by the
identity): n_s per root, the roots and the round levels bit-equal, BC
within 1e-6 relative (f32 column sums over fewer columns), on the dense,
sparse and fused engines, the liveness loop and a static bound, blocks of
1-3 lanes, the straggler loop, a sampled h0 run and a weighted run, with
``trimmed_slots`` against the count worked out from the schedule and the
other counters equal to the untrimmed run's."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch.graphs as pg
from repro_torch import tracing
from repro_torch.core import bc as pbc
from repro_torch.core import driver as pdriver
from repro_torch.core.scheduler import build_schedule
from repro_torch.serving.sampling import eligible_roots, plan_sampling

CPU = torch.device("cpu")
ENGINES = ["dense", "sparse", "fused"]
# R-MAT 8 under h3 in rounds of 8 (k = 4): the first five rounds claim
# 4, 4, 4, 4 and 2 derived slots, the other twelve none, so blocks of two
# and of three lanes each hold one that mixes claimed slots and none
GRAPH = pg.rmat_graph(8, 4, seed=2)
STATIC_LEVELS = 12


def _width(derived: np.ndarray) -> int:
    """One past the last derived slot of a round that has a root."""
    claimed = [i for i in range(derived.shape[0]) if derived[i, 0] >= 0]
    return claimed[-1] + 1 if claimed else 0


class _Recorded:
    """A round function that keeps every call's sources, derived width,
    n_s and roots on the host."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, sources, derived):
        out = self.fn(sources, derived)
        self.calls.append((sources.cpu().numpy().copy(), int(derived.shape[1]),
                           out[1].cpu().numpy().copy(), out[2].cpu().numpy().copy()))
        return out


def _ns_by_root(calls) -> dict[int, np.float32]:
    return {int(r): v for _, _, ns, roots in calls
            for r, v in zip(roots.reshape(-1), ns.reshape(-1)) if r >= 0}


def _roots(calls) -> list[list[int]]:
    return [[int(r) for r in lane if r >= 0] for _, _, _, roots in calls for lane in roots]


def _run(make_fn, schedule, *, n, prep, trim, **kw):
    """One driver run, trimmed (under a profiler, so the counters count)
    or untrimmed; returns the result, the recorded calls and the counts."""
    fn = _Recorded(make_fn())
    with pytest.MonkeyPatch.context() as mp:
        if not trim:
            mp.setattr(pdriver, "_shipped_derived", lambda ders: ders)
        with profile(activities=[ProfilerActivity.CPU]):
            result = pdriver.BCDriver(fn, schedule, n=n, device=CPU, prep=prep, **kw).run()
    return result, fn.calls, tracing.counts()


def _held(trimmed, untrimmed):
    (res_t, calls_t, _), (res_u, calls_u, _) = trimmed, untrimmed
    assert res_t.round_levels == res_u.round_levels
    assert _roots(calls_t) == _roots(calls_u)
    ns_t, ns_u = _ns_by_root(calls_t), _ns_by_root(calls_u)
    assert ns_t.keys() == ns_u.keys()
    assert all(ns_t[r].tobytes() == ns_u[r].tobytes() for r in ns_u)
    np.testing.assert_allclose(res_t.bc, res_u.bc, rtol=1e-6, atol=0)


def _block_rounds(schedule, sources: np.ndarray) -> list:
    """The schedule's round in each lane of a dispatched block (None for an
    all-padding lane), found by its sources."""
    by_sources = {r.sources.tobytes(): r for r in schedule.rounds}
    return [None if (lane < 0).all() else by_sources[lane.astype(np.int32).tobytes()]
            for lane in sources]


def _trimmed_by_hand(schedule, calls) -> int:
    """Σ over the dispatched blocks of fr · (k − w), w the widest claimed
    prefix of the block's rounds; each block's shipped width is checked
    against it on the way."""
    k = schedule.derived_per_round
    total = 0
    for sources, width, _, _ in calls:
        w = max([_width(r.derived) for r in _block_rounds(schedule, sources) if r is not None],
                default=0)
        assert width == w <= k
        total += sources.shape[0] * (k - w)
    return total


@pytest.fixture(scope="module")
def h3():
    return build_schedule(GRAPH, batch_size=8, heuristics="h3")


@pytest.mark.parametrize("fr", [1, 2, 3])
@pytest.mark.parametrize("num_levels", [None, STATIC_LEVELS], ids=["liveness", "static"])
@pytest.mark.parametrize("engine", ENGINES)
def test_a_trimmed_block_gives_the_untrimmed_round(h3, engine, num_levels, fr):
    schedule, prep, residual, omega = h3
    widths = [_width(r.derived) for r in schedule.rounds]
    blocks = [widths[i:i + fr] for i in range(0, len(widths), fr)]
    # claimed slots beside none in one block, and a block with none at all
    assert 0 < max(widths) == schedule.derived_per_round
    assert any(min(b) == 0 < max(b) for b in blocks if len(b) == fr) or fr == 1
    assert any(max(b) == 0 for b in blocks)
    omega_t = torch.from_numpy(omega).float()

    def make_fn():
        return pbc.make_round_fn(pbc.make_operator(residual, engine, CPU), omega_t, num_levels)

    kw = dict(n=GRAPH.n, prep=prep, rounds_per_dispatch=fr)
    trimmed = _run(make_fn, schedule, trim=True, **kw)
    untrimmed = _run(make_fn, schedule, trim=False, **kw)
    _held(trimmed, untrimmed)
    assert trimmed[2]["trimmed_slots"] == _trimmed_by_hand(schedule, trimmed[1]) > 0
    assert untrimmed[2]["trimmed_slots"] == 0
    assert {w for _, w, _, _ in untrimmed[1]} == {schedule.derived_per_round}
    # the column counters keep the schedule's width: the slots left out
    # count as padded backward columns, as when they ran
    trimmed[2].pop("trimmed_slots"), untrimmed[2].pop("trimmed_slots")
    assert trimmed[2] == untrimmed[2]


@pytest.mark.parametrize("policy", ["steal", "redeal"])
def test_the_straggler_loop_ships_the_trimmed_block_too(h3, policy):
    schedule, prep, residual, omega = h3
    omega_t = torch.from_numpy(omega).float()

    def make_fn():
        return pbc.make_round_fn(pbc.make_operator(residual, "fused", CPU), omega_t)

    kw = dict(n=GRAPH.n, prep=prep, rounds_per_dispatch=2, straggler=policy)
    trimmed = _run(make_fn, schedule, trim=True, **kw)
    untrimmed = _run(make_fn, schedule, trim=False, **kw)
    assert trimmed[0].rounds_run == untrimmed[0].rounds_run == len(schedule.rounds)
    np.testing.assert_allclose(trimmed[0].bc, untrimmed[0].bc, rtol=1e-6, atol=0)
    # the policy may deal the two runs apart (it reads the walls): compare
    # per root and per round, not per block
    ns_t, ns_u = _ns_by_root(trimmed[1]), _ns_by_root(untrimmed[1])
    assert ns_t.keys() == ns_u.keys()
    assert all(ns_t[r].tobytes() == ns_u[r].tobytes() for r in ns_u)
    assert sorted(trimmed[0].round_levels) == sorted(untrimmed[0].round_levels)
    assert trimmed[2]["trimmed_slots"] == _trimmed_by_hand(schedule, trimmed[1]) > 0


@pytest.mark.parametrize("engine", ENGINES)
def test_a_sampled_h0_run_ships_no_derived_slot(engine):
    plan = plan_sampling(eligible_roots(GRAPH), "fixed", sample_k=20, seed=5)
    schedule, prep, residual, omega = build_schedule(GRAPH, batch_size=8, heuristics="h0",
                                                     roots=plan.roots)
    assert all(_width(r.derived) == 0 for r in schedule.rounds)
    omega_t = torch.from_numpy(omega).float()

    def make_fn():
        return pbc.make_round_fn(pbc.make_operator(residual, engine, CPU), omega_t)

    trimmed = _run(make_fn, schedule, n=GRAPH.n, prep=prep, trim=True)
    untrimmed = _run(make_fn, schedule, n=GRAPH.n, prep=prep, trim=False)
    _held(trimmed, untrimmed)
    assert {w for _, w, _, _ in trimmed[1]} == {0}
    assert trimmed[2]["trimmed_slots"] == len(schedule.rounds) * schedule.derived_per_round


def test_a_weighted_run_ships_no_derived_slot():
    # the 2-degree derivation is level-based, so a weighted schedule claims
    # no derived slot; the bucket loops count no level steps, so the
    # counters read nothing here and the widths are checked on the calls
    graph = pg.weighted_copy(pg.grid_graph(5, 6), seed=1)
    schedule, prep, residual, omega = build_schedule(graph, batch_size=8, heuristics="h0")
    omega_t = torch.from_numpy(omega).float()
    delta = pbc.check_weighted(graph, True, None, "h0", None)

    def make_fn():
        return pbc.make_round_fn(pbc.make_weighted_operator(residual, "dense", delta, CPU),
                                 omega_t)

    trimmed = _run(make_fn, schedule, n=graph.n, prep=prep, trim=True)
    untrimmed = _run(make_fn, schedule, n=graph.n, prep=prep, trim=False)
    _held(trimmed, untrimmed)
    assert {w for _, w, _, _ in trimmed[1]} == {0}
    assert {w for _, w, _, _ in untrimmed[1]} == {schedule.derived_per_round}


@pytest.mark.parametrize("lanes, want", [
    # a claimed slot behind padding: the width runs to it, not by count
    ([[-1, -1, 7, -1], [-1, -1, -1, -1]], 3),
    ([[5, 6, -1, -1], [-1, -1, -1, 9]], 4),
    ([[-1] * 4, [-1] * 4, [-1] * 4], 0),
    ([[3, -1, -1, -1]], 1),
])
def test_the_width_is_one_past_the_last_claimed_slot_of_any_lane(lanes, want):
    ders = np.full((len(lanes), 4, 3), -1, np.int32)
    ders[:, :, 0] = lanes
    ders[:, :, 1:] = np.where(ders[:, :, :1] >= 0, 2, -1)
    got = pdriver._shipped_derived(ders)
    assert got.shape == (len(lanes), want, 3) and got.flags.c_contiguous
    np.testing.assert_array_equal(got, ders[:, :want])

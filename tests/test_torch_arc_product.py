"""The arc product's work list and its plain version on the CPU.

``kernels/arc_product.py:arc_plan`` is held to ``core/operators.py:_arc_pieces``
(every arc of the real rows in exactly one segment, each segment a piece,
the long rows' pieces first, heaviest row first), and the kernel's chain
over it (:func:`_work_list_chain`, an emulation of the kernel's order) to
the torch version ``operators._arc_sum``, which ``_arc_product`` and the
wrapper ``ops.arc_product`` run for CPU tensors, bit for bit, on operands
whose big terms cancel, where the summation order shows in the f32
result.  The kernel itself runs on the card only
(``tests/test_torch_gpu.py``).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import operators
from repro_torch.kernels import ops
from repro_torch.kernels.arc_product import ArcPlan, arc_plan
from repro_torch.roofline import counter as work

#: (rows, arcs, hub arcs into row 2, sentinel arcs, piece size)
LAYOUTS = {
    "no-pieces": (50, 300, 0, 20, 256),
    "hub-pieces": (40, 2400, 1000, 700, 256),
    "many-long-rows": (30, 400, 0, 25, 3),
}


def _arc_list(layout, monkeypatch):
    """A destination-sorted arc list over ``rows`` rows plus the sentinel
    row ``rows`` (whose padding arcs read the sentinel operand row), with
    empty rows, and its operands."""
    rows, arcs, hub, pad, piece = LAYOUTS[layout]
    monkeypatch.setattr(operators, "_ARC_PIECE", piece)
    rng = np.random.default_rng(len(layout))
    dst = rng.integers(0, rows // 2, arcs) * 2  # odd rows stay empty
    dst[:hub] = 2
    dst[hub:hub + pad] = rows
    src = rng.integers(0, rows, arcs)
    src[dst == rows] = rows
    src, _, _, lengths = operators._by_destination(torch.from_numpy(src), torch.from_numpy(dst),
                                                   None, rows)
    pieces, counts = operators._arc_pieces(lengths)
    assert (pieces is None) == (layout == "no-pieces")
    return rows, src, lengths, pieces, counts


def _operand(rows, s, seed):
    """f32 [rows + 1, s], the sentinel row zero: half the entries ±2^60,
    half of order 2^-10 .. 2^10, so that a float64 sum is exact only
    while the big terms cancel, and which small terms a sum keeps, and so
    its f32 bits, depends on its order."""
    rng = np.random.default_rng(seed)
    small = rng.standard_normal((rows + 1, s)) * 2.0 ** rng.integers(-10, 11, (rows + 1, s))
    big = rng.choice([-(2.0**60), 2.0**60], (rows + 1, s))
    x = np.where(rng.random((rows + 1, s)) < 0.5, big, small)
    x[rows] = 0.0
    return torch.from_numpy(x.astype(np.float32))


def _work_list_chain(x, plan):
    """The kernel's chain over its work list, in plain torch: f32
    [plan.rows, s].  Each segment's operand rows ``x[src]``, widened to
    float64, are summed in arc order from 0.0 (``segment_reduce``: one
    sequential sum a segment and column); a long row's piece sums are then
    summed in piece order from 0.0; each row is rounded once to f32."""
    seg = plan.seg.long()
    row, lo, hi = seg[:, 0], seg[:, 1], seg[:, 2]
    lengths = hi - lo
    arcs = (torch.arange(int(lengths.sum()))
            + torch.repeat_interleave(lo - (lengths.cumsum(0) - lengths), lengths))
    msgs = x.index_select(0, plan.src.long()[arcs]).to(torch.float64)
    sums = torch.segment_reduce(msgs, "sum", lengths=lengths, axis=0)
    out = x.new_empty((plan.rows, x.shape[1]))
    n = plan.n_long_seg
    out[row[n:]] = sums[n:].to(x.dtype)
    if n:
        ptr = plan.long_ptr.long()
        rows = torch.segment_reduce(sums[:n], "sum", lengths=ptr[1:] - ptr[:-1], axis=0)
        out[row[ptr[:-1]]] = rows.to(x.dtype)
    return out


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_work_list_covers_every_arc_once_in_piece_order_long_rows_first(layout, monkeypatch):
    rows, src, lengths, pieces, counts = _arc_list(layout, monkeypatch)
    plan = arc_plan(src, pieces, counts, rows)
    assert isinstance(plan, ArcPlan) and plan.rows == rows
    assert plan.pieces is pieces and plan.counts is counts
    assert all(t.dtype == torch.int32 for t in plan.arrays)
    assert torch.equal(plan.src, src.to(torch.int32))
    seg = plan.seg.long()
    ptr = plan.long_ptr.long()
    n = plan.n_long_seg
    assert int(ptr[0]) == 0 and int(ptr[-1]) == n
    start = (lengths.cumsum(0) - lengths).tolist()
    # each row's pieces as _arc_pieces cut them, as (lo, hi) arc ranges
    if pieces is None:
        cut = [[(start[r], start[r] + int(lengths[r]))] for r in range(rows)]
    else:
        bounds = torch.cat([torch.zeros(1, dtype=torch.long), pieces.cumsum(0)]).tolist()
        first = (counts.cumsum(0) - counts).tolist()
        cut = [[(bounds[p], bounds[p + 1]) for p in range(first[r], first[r] + int(counts[r]))]
               for r in range(rows)]
    long_rows = [int(seg[int(ptr[i]), 0]) for i in range(ptr.numel() - 1)]
    assert long_rows == sorted((r for r in range(rows) if len(cut[r]) > 1),
                               key=lambda r: (-len(cut[r]), r))
    assert (len(long_rows) > 0) == (layout != "no-pieces")
    for i, r in enumerate(long_rows):
        mine = seg[int(ptr[i]):int(ptr[i + 1])]
        assert (mine[:, 0] == r).all()
        assert [tuple(x) for x in mine[:, 1:].tolist()] == cut[r]
    short = [r for r in range(rows) if len(cut[r]) == 1]
    assert seg[n:, 0].tolist() == short
    assert [tuple(x) for x in seg[n:, 1:].tolist()] == [cut[r][0] for r in short]
    covered = torch.cat([torch.arange(lo, hi) for lo, hi in seg[:, 1:].tolist()])
    assert torch.equal(covered.sort().values, torch.arange(int(lengths[:rows].sum())))


@pytest.mark.parametrize("pass_bytes", [0, 1 << 30], ids=["four-passes", "one-pass"])
@pytest.mark.parametrize("s", [1, 7, 24, 25])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_kernel_chain_over_the_work_list_equals_the_torch_version_bitwise(layout, s, pass_bytes,
                                                                          monkeypatch):
    """The kernel's order (each segment from 0.0, then a long row's pieces
    from 0.0, one rounding) over the work list equals the torch version's
    bits, which ``_arc_product`` and the wrapper give on the CPU, where
    nothing launches."""
    monkeypatch.setattr(operators, "_ARC_PASS_BYTES", pass_bytes)
    rows, src, lengths, pieces, counts = _arc_list(layout, monkeypatch)
    plan = arc_plan(src, pieces, counts, rows)
    x = _operand(rows, s, seed=s)
    want = operators._arc_sum(x, src, pieces, counts, rows)
    ops.reset_launches()
    assert torch.equal(operators._arc_product(x, src, pieces, counts, rows), want)
    assert torch.equal(_work_list_chain(x, plan), want)
    assert torch.equal(ops.arc_product(x, plan, rows), want)
    assert ops.LAUNCHES["arc_product"] == 0
    # the row sums, within f32 rounding plus f64 rounding at the scale of Σ|terms|
    dst = torch.repeat_interleave(torch.arange(rows + 1), lengths).numpy()
    terms = x.numpy().astype(np.float64)[src.numpy()]
    sums, scale = np.zeros((rows + 1, s)), np.zeros((rows + 1, s))
    np.add.at(sums, dst, terms)
    np.add.at(scale, dst, np.abs(terms))
    err = np.abs(want.numpy() - sums[:rows])
    assert (err <= 2.0**-24 * np.abs(sums[:rows]) + 2.0**-40 * scale[:rows]).all()


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_work_counter_terms_of_the_cards_operands_equal_the_torch_versions(layout, monkeypatch):
    """The card's operands (the plan's int32 index, the only one it keeps)
    count as the torch version's int64 index: the same terms."""
    rows, src, lengths, pieces, counts = _arc_list(layout, monkeypatch)
    plan = arc_plan(src, pieces, counts, rows)
    x = _operand(rows, 16, seed=1)
    with work.WorkCounter() as plain:
        want = operators._arc_product(x, src, pieces, counts, rows)
    with work.WorkCounter() as kernel:
        got = operators._arc_product(x, plan.src, pieces, counts, rows, plan)
    assert src.dtype == torch.int64 and torch.equal(got, want)
    assert kernel.by_name() == plain.by_name()
    assert set(plain.by_name()) == {"arc_gather", "arc_sum"}


def test_arc_product_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch):
    rows, src, lengths, pieces, counts = _arc_list("hub-pieces", monkeypatch)
    plan = arc_plan(src, pieces, counts, rows)
    x = _operand(rows, 8, seed=2)
    ops.reset_launches()
    with pytest.raises(ValueError, match="work list"):
        ops.arc_product(x, None, rows)
    with pytest.raises(TypeError, match="float32"):
        ops.arc_product(x.double(), plan, rows)
    with pytest.raises(ValueError, match="contiguous"):
        ops.arc_product(_operand(rows, 16, seed=2)[:, ::2], plan, rows)
    with pytest.raises(ValueError, match="rows"):
        ops.arc_product(x, plan, rows - 1)
    with pytest.raises(TypeError, match="int32"):
        ops.arc_product(x, plan._replace(seg=plan.seg.long()), rows)
    with pytest.raises(ValueError, match="segment"):
        ops.arc_product(x, plan._replace(seg=plan.seg[1:]), rows)
    assert ops.LAUNCHES["arc_product"] == 0


def test_sparse_operator_on_the_cpu_builds_no_plan_and_keeps_the_torch_version(monkeypatch):
    rows, src, lengths, pieces, counts = _arc_list("hub-pieces", monkeypatch)
    dst = torch.repeat_interleave(torch.arange(rows + 1), lengths)
    op = operators.SparseOperator(src, dst, rows)
    assert op.plan is None
    x = _operand(rows, 5, seed=3)[:rows]
    ops.reset_launches()
    got = op.apply(x)
    x_pad = torch.cat([x, x.new_zeros((1, 5))])
    assert torch.equal(got, operators._arc_sum(x_pad, op.src, op.pieces, op.counts, rows))
    assert ops.LAUNCHES["arc_product"] == 0

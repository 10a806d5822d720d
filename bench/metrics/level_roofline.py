"""level_roofline: the least time the window's real levels need on the
chip (``bcbench.roofline.round_bound_seconds`` of each completed round:
arcs read once as int32 pairs, one f32 state of the level's columns read
and written once, 2 FLOP per arc and column; the data sheet's peaks)
as a share of the traced window."""
from bcbench.roofline import round_bound_seconds


def read(ctx):
    if ctx.trace is None or not ctx.rounds or ctx.trace.window_s <= 0 or not ctx.trace.device:
        return None
    bound = sum(round_bound_seconds(lv, explicit, cols, ctx.arcs, ctx.n, ctx.kind)
                for lv, explicit, cols in ctx.rounds)
    return 100.0 * bound / ctx.trace.window_s

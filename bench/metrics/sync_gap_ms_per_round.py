"""sync_gap_ms_per_round: device-idle milliseconds of the traced window per
completed round, over the gaps whose start lies inside a ``bc.readback``
span, the innermost program span open there: the host waiting on a
device-to-host read (liveness flags, depth maxima, the block's n_s, roots
and levels, the accumulator).  See ``bcbench.spans.gap_seconds``."""
from bcbench.spans import SYNC, gap_ms_per_round


def read(ctx):
    return gap_ms_per_round(ctx, SYNC)

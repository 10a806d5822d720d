"""collective_gap_ms_per_round: device-idle milliseconds of the traced window
per completed round, over the gaps whose start lies inside a
``bc.collective.*`` span, the innermost program span open there: the host
inside one of ``distributed/groups.py``'s collectives.  See
``bcbench.spans.gap_seconds``."""
from bcbench.spans import COLLECTIVE, gap_ms_per_round


def read(ctx):
    return gap_ms_per_round(ctx, COLLECTIVE)

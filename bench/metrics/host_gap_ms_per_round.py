"""host_gap_ms_per_round: device-idle milliseconds of the traced window per
completed round, over the gaps whose start lies inside any other program
span (``bc.block``, ``bc.round``, ``bc.level.*``) as the innermost one open
there: the host's own work between launches.  See
``bcbench.spans.gap_seconds``."""
from bcbench.spans import HOST, gap_ms_per_round


def read(ctx):
    return gap_ms_per_round(ctx, HOST)

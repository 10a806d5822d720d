"""collective_ms_per_round: device milliseconds of the collectives in the
traced window (the union of the activities NCCL's host ops launched, see
``bcbench.trace``) per completed round; none on a path without them."""


def read(ctx):
    if ctx.trace is None or not ctx.rounds:
        return None
    ms = 1e3 * ctx.trace.collective_s
    return ms / len(ctx.rounds) if ms > 0 else None

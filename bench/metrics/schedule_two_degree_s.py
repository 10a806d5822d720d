"""schedule_two_degree_s: host seconds of ``build_schedule``'s
``bc.schedule.two_degree`` phase (the residual degrees, the adjacency lists
and ``claim_two_degree``), as the program's ``tracing.seconds()`` keeps
them."""
from bcbench.spans import program_seconds


def read(ctx):
    if ctx.trace is None or not ctx.rounds:
        return None
    return program_seconds().get("bc.schedule.two_degree")

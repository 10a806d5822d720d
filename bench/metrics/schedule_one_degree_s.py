"""schedule_one_degree_s: host seconds of ``build_schedule``'s
``bc.schedule.one_degree`` phase (the 1-degree reduction,
``one_degree_reduce``), as the program's ``tracing.seconds()`` keeps them."""
from bcbench.spans import program_seconds


def read(ctx):
    if ctx.trace is None or not ctx.rounds:
        return None
    return program_seconds().get("bc.schedule.one_degree")

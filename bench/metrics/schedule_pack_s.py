"""schedule_pack_s: host seconds of ``build_schedule``'s
``bc.schedule.pack`` phase (the triples' placement, the explicit fill and
the ``Schedule``), as the program's ``tracing.seconds()`` keeps them."""
from bcbench.spans import program_seconds


def read(ctx):
    if ctx.trace is None or not ctx.rounds:
        return None
    return program_seconds().get("bc.schedule.pack")

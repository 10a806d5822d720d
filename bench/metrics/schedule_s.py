"""schedule_s: host seconds of the program's h3 schedule (``build_schedule``:
the 1-/2-degree heuristics and the rounds), timed around the call."""


def read(ctx):
    return ctx.spans.get("schedule")

"""empty_level_pct: the share of the window's level steps in which no
column can change (the program's ``empty_level_steps`` over its
``level_steps``, ``repro_torch/tracing.py``): the liveness loop's last
forward step, and a static bound's steps past the round's depth."""
from bcbench.spans import program_counts


def read(ctx):
    if ctx.trace is None or not ctx.rounds:
        return None
    c = program_counts()
    if not c.get("level_steps"):
        return None
    return 100.0 * c["empty_level_steps"] / c["level_steps"]

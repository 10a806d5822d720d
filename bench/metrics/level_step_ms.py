"""level_step_ms: device-busy milliseconds of the traced window (the union
of its device intervals) per level step the window dispatched (counted on
the operator's level-step methods, ``bcbench.cell.LevelSteps``)."""


def read(ctx):
    if ctx.trace is None or not ctx.level_steps:
        return None
    busy = ctx.trace.busy_s
    return 1e3 * busy / ctx.level_steps if busy > 0 else None

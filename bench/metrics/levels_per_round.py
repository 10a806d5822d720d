"""levels_per_round: level steps the window's rounds dispatched, counted
where they happen (the benchmark's counter on the operator's level-step
methods, ``bcbench.cell.LevelSteps``), per completed round."""


def read(ctx):
    if not ctx.rounds or not ctx.level_steps:
        return None
    return ctx.level_steps / len(ctx.rounds)

"""live_column_pct: the share of the columns the window's level steps ran
that the step could change (the program's ``live_columns`` over its
``operand_columns``, ``repro_torch/tracing.py``): a forward step ℓ is live
for a column with a vertex at depth ℓ, a backward step ℓ for one with a
vertex at depth ℓ + 1; padding columns never are."""
from bcbench.spans import program_counts


def read(ctx):
    if ctx.trace is None or not ctx.rounds:
        return None
    c = program_counts()
    if not c.get("operand_columns"):
        return None
    return 100.0 * c["live_columns"] / c["operand_columns"]

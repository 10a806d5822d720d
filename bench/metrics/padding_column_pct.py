"""padding_column_pct: the share of the columns the window's level steps
ran that have no root (the program's ``padded_columns`` over its
``operand_columns``, ``repro_torch/tracing.py``): an unfilled source slot
in the forward loop, an unfilled source or derived slot in the backward
loop.  Nothing to read where the program does not count them."""
from bcbench.spans import program_counts


def read(ctx):
    if ctx.trace is None or not ctx.rounds:
        return None
    c = program_counts()
    if not c.get("operand_columns") or "padded_columns" not in c:
        return None
    return 100.0 * c["padded_columns"] / c["operand_columns"]

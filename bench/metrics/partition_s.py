"""partition_s: host seconds of ``partition_2d`` and of the rank's arc
arrays and ω on the device (``distributed_graph_arrays``), timed around
the calls; only a grid path has them."""


def read(ctx):
    return ctx.spans.get("partition")

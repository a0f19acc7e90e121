"""ICP iterations per match pair, the mean over the online ticks (counter
``icp_iters``)."""

from benchmark import tick_trace


def read(ctx):
    return tick_trace.counter(ctx, "icp_iters")

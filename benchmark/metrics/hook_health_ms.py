"""Host milliseconds per health hook of the online loop, the mean of span
``health`` over the window's ticks that ran it (``fastslam.hook.health``)."""

from benchmark import hook_trace


def read(ctx):
    return hook_trace.span_ms(ctx, "health")

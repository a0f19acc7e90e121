"""Host milliseconds per checkpoint hook of the online loop, the mean of span
``checkpoint`` over the window's ticks that ran it (``fastslam.hook.checkpoint``)."""

from benchmark import hook_trace


def read(ctx):
    return hook_trace.span_ms(ctx, "checkpoint")

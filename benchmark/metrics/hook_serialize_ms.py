"""Host milliseconds per serialize hook of the online loop, the mean of span
``serialize`` over the window's ticks that ran it (``fastslam.hook.serialize``)."""

from benchmark import hook_trace


def read(ctx):
    return hook_trace.span_ms(ctx, "serialize")

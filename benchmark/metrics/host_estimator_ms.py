"""Host milliseconds per online tick in the floor estimator: its read
before the tick and its residuals and push after it (span ``estimator``)."""

from benchmark import tick_trace


def read(ctx):
    return tick_trace.span_ms(ctx, "estimator")

"""Host milliseconds per online tick spent waiting for the card: the
read-back of the tick's output row (span ``wait``)."""

from benchmark import tick_trace


def read(ctx):
    return tick_trace.span_ms(ctx, "wait")

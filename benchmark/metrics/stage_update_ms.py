"""The fused tick's update stage, device milliseconds per tick: the
proposal and the update kernel (stage mark ``update``)."""

from benchmark import tick_trace


def read(ctx):
    return tick_trace.stage_ms(ctx, "update")

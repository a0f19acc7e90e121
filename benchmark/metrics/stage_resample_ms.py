"""The fused tick's resample stage, device milliseconds per tick: normalize,
Neff, the staircase, the gather, the argmax estimate and the copy-back into
the static state (stage mark ``resample``)."""

from benchmark import tick_trace


def read(ctx):
    return tick_trace.stage_ms(ctx, "resample")

"""The share of the online ticks whose resample was due: the resample
stage gathers the state every tick, and this is its useful share (counter
``resample_due``)."""

from benchmark import tick_trace


def read(ctx):
    due = tick_trace.counter(ctx, "resample_due")
    return None if due is None else 100.0 * due

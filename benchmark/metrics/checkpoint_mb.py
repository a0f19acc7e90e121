"""Megabytes (10^6 bytes) a checkpoint writes to disk, the mean of the
counter ``checkpoint_bytes`` over the window's checkpoints."""

from benchmark import hook_trace


def read(ctx):
    size = hook_trace.counter_mean(ctx, "checkpoint_bytes")
    return None if size is None else 1e-6 * size

"""The filter step's share of its roofline, in %: the least seconds per tick
that the reference counted for the checked chunks (``roofline.py``: bytes
over 3.35 TB/s or operations over 67 TFLOP/s, whichever is larger), over
the device's busy seconds per tick in the traced window."""


def read(ctx):
    if ctx.get("kind") != "filter" or not ctx.get("bound_s_per_tick") or not ctx.get("busy_s"):
        return None
    return 100.0 * ctx["bound_s_per_tick"] / (ctx["busy_s"] / ctx["ticks"])

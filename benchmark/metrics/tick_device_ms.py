"""The card's busy milliseconds per online tick: the union of device
operations in the traced window over the ticks in it."""


def read(ctx):
    if ctx.get("kind") != "online" or not ctx.get("busy_s") or not ctx.get("ticks"):
        return None
    return 1e3 * ctx["busy_s"] / ctx["ticks"]

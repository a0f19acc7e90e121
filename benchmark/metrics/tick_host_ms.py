"""The host's milliseconds per online tick: the mean wall time of a tick
(scan handed over to pose returned) less the card's busy time per tick."""


def read(ctx):
    if ctx.get("kind") != "online" or not ctx.get("busy_s") or not ctx.get("ticks"):
        return None
    return 1e3 * (ctx["mean_tick_s"] - ctx["busy_s"] / ctx["ticks"])

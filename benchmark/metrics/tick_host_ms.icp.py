"""The host's milliseconds per online tick, as ``tick_host_ms`` reads
them, in the cells that report no ``tick_p95_ms``: there they move
``frames_per_s``."""


def read(ctx):
    if ctx.get("kind") != "online" or not ctx.get("busy_s") or not ctx.get("ticks"):
        return None
    return 1e3 * (ctx["mean_tick_s"] - ctx["busy_s"] / ctx["ticks"])

"""The 95th percentile, over every tick of the traced window, of the
host-clock time from handing a scan over to the return of its pose: the
end-to-end ``tick_p95_ms`` as a per-layer reading, for the cells whose
runs spread too widely to hold it to a bound (it moves ``frames_per_s``
there).  The profiler is on in the traced run, so it reads above the
untraced tail."""


def read(ctx):
    if ctx.get("kind") != "online" or not ctx.get("ticks") or not ctx.get("busy_s"):
        return None
    return 1e3 * ctx["p95_tick_s"]

"""The share of the traced window's wall time that the online loop spends
in its production hooks: the window's ``hook`` spans (each tick's hooks,
``fastslam.hook``) over the window's length."""

from benchmark import hook_trace


def read(ctx):
    inside = hook_trace.span_total_s(ctx, "hook")
    if inside is None or not ctx.get("window_s"):
        return None
    return 100.0 * inside / ctx["window_s"]

"""The share of the traced window, in %, in which no kernel, copy or set
ran on the card, in an online cell."""


def read(ctx):
    if ctx.get("kind") != "online" or not ctx.get("window_s"):
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])

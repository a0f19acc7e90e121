"""The share of the traced window, in %, in which no kernel, copy or set
ran on the card, in a chunked filter cell."""


def read(ctx):
    if ctx.get("kind") != "filter" or not ctx.get("window_s"):
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])

"""Share of the traced window, in %, in which no kernel, copy or memset
ran on the card."""

SPANS = []
COUNTERS = []


def read(ctx):
    w = (ctx.trace["w1"] - ctx.trace["w0"]) / 1e6
    if w <= 0:
        return None
    busy = ctx.trace["busy"]
    b = float((busy[:, 1] - busy[:, 0]).sum()) / 1e6 if len(busy) else 0.0
    return 100.0 * (1.0 - b / w)

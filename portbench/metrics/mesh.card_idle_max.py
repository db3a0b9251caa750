"""The idlest card's share of the traced window, in %, in which no kernel,
copy or memset ran on it: 100 x (1 - busy / window) from
ctx.card_busy_seconds(), over every card of the cell; a card the trace
never shows counts as idle throughout."""

SPANS = []
COUNTERS = []


def read(ctx):
    w = (ctx.trace["w1"] - ctx.trace["w0"]) / 1e6
    if w <= 0:
        return None
    busy = list(ctx.card_busy_seconds().values())
    busy += [0.0] * (ctx.cell.chips - len(busy))
    return 100.0 * (1.0 - min(busy) / w)

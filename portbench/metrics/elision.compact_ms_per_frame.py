"""Host ms a delivered frame in still elision's numpy compaction
(spans/elision.json)."""

SPANS = ["elision"]
COUNTERS = []


def read(ctx):
    s = ctx.spans.seconds("elision")
    return None if s is None or not ctx.frames else 1e3 * s / ctx.frames

"""Host ms a delivered frame in the native decode entries
(spans/native.json: the SP entropy decodes, the MSV1 parse)."""

SPANS = ["native"]
COUNTERS = []


def read(ctx):
    s = ctx.spans.seconds("native")
    return None if s is None or not ctx.frames else 1e3 * s / ctx.frames

"""Host ms a delivered frame in the per-window host call of the path
(spans/ingest.json: _decode_window, or _lane_group on the lane path)."""

SPANS = ["ingest"]
COUNTERS = []


def read(ctx):
    s = ctx.spans.seconds("ingest")
    return None if s is None or not ctx.frames else 1e3 * s / ctx.frames

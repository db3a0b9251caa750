"""Host ms a delivered frame in what each pass pays before its first
window (spans/demux.json): the pipeline's construction, which demuxes
every AVI source or inflates and parses every lane container, and the
keyframe probing."""

SPANS = ["demux"]
COUNTERS = []


def read(ctx):
    s = ctx.spans.seconds("demux")
    return None if s is None or not ctx.frames else 1e3 * s / ctx.frames

"""Hand-written kernel launches a delivered frame: the sum of the
wrappers' .launches (counters/kernels.json) over the window."""

SPANS = []
COUNTERS = ["kernels"]


def read(ctx):
    if not ctx.launches or not ctx.frames:
        return None
    return sum(ctx.launches.values()) / ctx.frames

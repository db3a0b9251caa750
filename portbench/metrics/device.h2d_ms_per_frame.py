"""Device ms a delivered frame of host-to-device copies (the trace's
Memcpy HtoD events inside the window)."""

SPANS = []
COUNTERS = []


def read(ctx):
    s = ctx.device_seconds(cats=("gpu_memcpy",), name_has="HtoD")
    return None if not ctx.frames else 1e3 * s / ctx.frames

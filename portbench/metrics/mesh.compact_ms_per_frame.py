"""Host ms a delivered frame of the port's jsp.compact span, total: still
elision's compaction, which on a mesh gathers the changed paycode planes
on the host for the slots (portbench/program.py)."""

from portbench.program import summary

SPANS = []
COUNTERS = []


def read(ctx):
    s = summary()
    v = None if s is None else s["total_s"].get("jsp.compact")
    return None if v is None or not ctx.frames else 1e3 * v / ctx.frames

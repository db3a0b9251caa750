"""Host ms a delivered frame of the port's jsp.refill_wait span, total:
a window waiting, before it refills a pooled host plane, for the
non-blocking copies that still read it (portbench/program.py).  A port
that opens no such span gives nothing."""

from portbench.program import summary

SPANS = []
COUNTERS = []


def read(ctx):
    s = summary()
    v = None if s is None else s["total_s"].get("jsp.refill_wait")
    return None if v is None or not ctx.frames else 1e3 * v / ctx.frames

"""Host ms a delivered frame of the port's jsp.scan span, self time: the
device scan's enqueue (kernel wrappers and their torch ops), the uploads
made as its arguments subtracted (portbench/program.py)."""

from portbench.program import self_ms_per_frame

SPANS = []
COUNTERS = []


def read(ctx):
    return self_ms_per_frame(ctx, "jsp.scan")

"""Host ms a delivered frame of the port's jsp.window span that no child
span covers: the window loop's own host work (portbench/program.py)."""

from portbench.program import self_ms_per_frame

SPANS = []
COUNTERS = []


def read(ctx):
    return self_ms_per_frame(ctx, "jsp.window")

"""Host ms a delivered frame of the port's jsp.entropy span, self time:
each path's per-frame host decode loop (SP entropy decode, MSV1 parse),
the loop included (portbench/program.py)."""

from portbench.program import self_ms_per_frame

SPANS = []
COUNTERS = []


def read(ctx):
    return self_ms_per_frame(ctx, "jsp.entropy")

"""Host ms a delivered frame of the port's jsp.prep span, self time: host
arrays assembled between decode and upload (MSV1's command arrays and
sel_to_plane, the CONCAT concatenations and outmaps, the lane groups'
bucketed arrays and init planes; portbench/program.py)."""

from portbench.program import self_ms_per_frame

SPANS = []
COUNTERS = []


def read(ctx):
    return self_ms_per_frame(ctx, "jsp.prep")

"""Host ms a delivered frame of the port's jsp.upload span, self time: the
host side of each pageable, blocking copy in device.to_device
(portbench/program.py)."""

from portbench.program import self_ms_per_frame

SPANS = []
COUNTERS = []


def read(ctx):
    return self_ms_per_frame(ctx, "jsp.upload")

"""Bytes a delivered frame that the port's device.to_device uploaded: its
upload.bytes counter over the window (portbench/program.py)."""

from portbench.program import counter

SPANS = []
COUNTERS = []


def read(ctx):
    n = counter("upload.bytes")
    return None if n is None or not ctx.frames else n / ctx.frames

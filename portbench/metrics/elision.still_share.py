"""Share of the timeline's frames, in %, that still elision kept out of
the device scan: the port's frames.elided counter over frames.timeline
(portbench/program.py)."""

from portbench.program import counter

SPANS = []
COUNTERS = []


def read(ctx):
    elided, timeline = counter("frames.elided"), counter("frames.timeline")
    if elided is None or not timeline:
        return None
    return 100.0 * elided / timeline

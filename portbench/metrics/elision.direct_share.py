"""Share of the real rows of the device scan, in %, that still elision
placed straight from the pooled host window into the device row stack, no
host copy of a plane between: the port's elision.direct_rows counter over
frames.scanned less rows.padded (portbench/program.py).  A port that
gathers the changed planes on the host first counts no direct rows and
gives nothing."""

from portbench.program import counter

SPANS = []
COUNTERS = []


def read(ctx):
    direct, scanned = counter("elision.direct_rows"), counter("frames.scanned")
    if direct is None or not scanned:
        return None
    real = scanned - (counter("rows.padded") or 0)
    return 100.0 * direct / real if real > 0 else None

"""Host ms a delivered frame of the port's jsp.audio span, self time: the
MP3 parsing that each stream's StreamReader drives in the pipeline's
construction (the up-front drain of its track), which each pass pays
(portbench/program.py)."""

from portbench.program import self_ms_per_frame

SPANS = []
COUNTERS = []


def read(ctx):
    return self_ms_per_frame(ctx, "jsp.audio")

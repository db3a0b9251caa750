"""Host ms a delivered frame of the port's jsp.epilogue span, self time:
the model tensors' torch ops and ds2_pack launch, as the host enqueues
them (portbench/program.py)."""

from portbench.program import self_ms_per_frame

SPANS = []
COUNTERS = []


def read(ctx):
    return self_ms_per_frame(ctx, "jsp.epilogue")

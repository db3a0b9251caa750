"""Host ms a delivered frame of the port's jsp.shard span, total: the
mesh's run_bg and run_rows building every slot's inputs, its uploads
(jsp.upload, children) included (portbench/program.py).  A port whose
mesh opens no such span gives nothing."""

from portbench.program import summary

SPANS = []
COUNTERS = []


def read(ctx):
    s = summary()
    v = None if s is None else s["total_s"].get("jsp.shard")
    return None if v is None or not ctx.frames else 1e3 * v / ctx.frames

"""Share of the uploaded bytes, in %, copied from page-locked host pages
without blocking the host: the port's upload.pinned_bytes counter over
upload.bytes (portbench/program.py).  A port that pins no pages gives
nothing where it has no such counter, and 0 where it has one."""

from portbench.program import counter

SPANS = []
COUNTERS = []


def read(ctx):
    total = counter("upload.bytes")
    if not total:
        return None
    pinned = counter("upload.pinned_bytes")
    if pinned is None:
        try:  # the port counts pinned bytes: it pinned none in this run
            from jsplayer_tpu_torch.device import pin_host  # noqa: F401
        except ImportError:
            return None
        pinned = 0
    return 100.0 * pinned / total

"""The kernels' share of the bytes roofline, in %.

The bytes are the decode's own work, counted from the cell's inputs and
what the window delivered, whatever implements it: every coded input byte
of the delivered frames read once, every delivered output (frames_u32
rows and model tensors) written once.  Their least time is the bytes over
the card's HBM bandwidth (peaks/h100_sxm.json); the share is that over
the device time of every kernel in the window's trace.  A share above
100% would mean the bytes are counted too high or the time leaves work
out; it is never clipped.
"""

SPANS = []
COUNTERS = []


def read(ctx):
    k = ctx.device_seconds(cats=("kernel",))
    if k <= 0:
        return None
    need = (ctx.coded_bytes + ctx.out_bytes) / ctx.peaks()["hbm_bytes_per_s"]
    return 100.0 * need / k

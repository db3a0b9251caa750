"""Bytes a delivered frame that crossed between the mesh's slots: the
port's mesh.exchange_bytes counter over the window, every result a slot
returns to the gather slot and every tensor input (the carry) the gather
slot sends to another (portbench/program.py).  One slot a card, these are
the device trace's peer copies.  A port whose mesh counts nothing gives
nothing."""

from portbench.program import counter

SPANS = []
COUNTERS = []


def read(ctx):
    n = counter("mesh.exchange_bytes")
    return None if n is None or not ctx.frames else n / ctx.frames

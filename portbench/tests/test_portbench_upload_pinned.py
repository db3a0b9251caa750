"""upload.pinned_share and upload.wait_ms_per_frame, from a fake
TRACE.summary(): the bytes copied from pinned pages over every uploaded
byte, and the refill waits' host ms a delivered frame; None where the port
has no tracer, uploaded nothing, counts no pinned bytes for want of the
counter, or never waited."""

from __future__ import annotations

import pytest

# imported before any test swaps the tracer: the module binds it by name
import jsplayer_tpu_torch.device  # noqa: F401
from portbench.harness import Context
from portbench.spec import CHECKOUT, Bench

BENCH = Bench(CHECKOUT)
CELLS = ["sp1080_terminal_kmv_elided", "sp1080_terminal_kmv_elided_dp4"]
METRICS = ["upload.pinned_share", "upload.wait_ms_per_frame"]


class FakeTracer:
    def __init__(self, counters=None, total_s=None):
        self._s = {"self_s": dict(total_s or {}),
                   "total_s": dict(total_s or {}), "calls": {},
                   "counters": dict(counters or {})}

    def summary(self):
        return self._s


def ctx(cell="sp1080_terminal_kmv_elided", frames=200):
    return Context(cell=BENCH.cell(cell), spans=None, launches={},
                   trace=None, frames=frames, window_s=1.0, coded_bytes=0,
                   out_bytes=0)


def read(monkeypatch, name, c=None, **fake):
    from jsplayer_tpu_torch.utils import logging

    monkeypatch.setattr(logging, "TRACE", FakeTracer(**fake))
    return BENCH.module("metrics", name).read(c or ctx())


@pytest.mark.parametrize("name", METRICS)
def test_in_benchmark_json(name):
    m = next(m for m in BENCH.spec["per_layer"] if m["name"] == name)
    assert (m["better"], m["moves"], m["workloads"]) == (
        "higher" if name == "upload.pinned_share" else "lower",
        "delivered_fps", CELLS)
    assert m["layer"] == "device.to_device, the upload"
    assert (m["unit"], m["source"]) == (
        ("%", "program_counter") if name == "upload.pinned_share"
        else ("ms/frame", "program_span"))


@pytest.mark.parametrize("counters,want", [
    ({"upload.bytes": 1000, "upload.pinned_bytes": 1000}, 100.0),
    ({"upload.bytes": 1000, "upload.pinned_bytes": 990}, 99.0),
    ({"upload.bytes": 1000}, 0.0),  # the port pinned nothing this run
    ({"upload.pinned_bytes": 10}, None),
    ({}, None),
])
def test_pinned_share(monkeypatch, counters, want):
    got = read(monkeypatch, "upload.pinned_share", counters=counters)
    assert got == (pytest.approx(want) if want is not None else None)


def test_pinned_share_none_from_a_port_without_the_counter(monkeypatch):
    """A port whose device module has no pin_host (the parent of the
    pinned pool) gives nothing, not 0."""
    from jsplayer_tpu_torch import device

    monkeypatch.delattr(device, "pin_host")
    assert read(monkeypatch, "upload.pinned_share",
                counters={"upload.bytes": 1000}) is None


@pytest.mark.parametrize("total_s,frames,want", [
    ({"jsp.refill_wait": 0.05}, 200, 0.25),
    ({"jsp.refill_wait": 0.0}, 200, 0.0),
    ({"jsp.refill_wait": 0.05}, 0, None),
    ({"jsp.upload": 1.0}, 200, None),
])
def test_wait_ms_per_frame(monkeypatch, total_s, frames, want):
    got = read(monkeypatch, "upload.wait_ms_per_frame",
               c=ctx(CELLS[1], frames), total_s=total_s)
    assert got == (pytest.approx(want) if want is not None else None)


@pytest.mark.parametrize("name", METRICS)
def test_none_from_a_port_without_the_tracer(monkeypatch, name):
    from jsplayer_tpu_torch.utils import logging

    monkeypatch.delattr(logging, "TRACE")
    assert BENCH.module("metrics", name).read(ctx()) is None

"""elision.direct_share: the rows still elision placed straight from the
pooled window over the scan's real rows, from a fake TRACE.summary(); None
where the port counted no direct rows (one that compacts planes on the
host, or a cell without still elision) or has no tracer."""

from __future__ import annotations

import pytest

from portbench.harness import Context
from portbench.spec import CHECKOUT, Bench

BENCH = Bench(CHECKOUT)


class FakeTracer:
    def __init__(self, counters):
        self._s = {"self_s": {}, "total_s": {}, "calls": {},
                   "counters": counters}

    def summary(self):
        return self._s


def read(monkeypatch, counters):
    from jsplayer_tpu_torch.utils import logging

    monkeypatch.setattr(logging, "TRACE", FakeTracer(counters))
    c = Context(cell=BENCH.cell("sp1080_terminal_kmv_elided"), spans=None,
                launches={}, trace=None, frames=200, window_s=1.0,
                coded_bytes=0, out_bytes=0)
    return BENCH.module("metrics", "elision.direct_share").read(c)


def test_in_benchmark_json():
    m = next(m for m in BENCH.spec["per_layer"]
             if m["name"] == "elision.direct_share")
    assert (m["unit"], m["better"], m["source"], m["moves"]) == (
        "%", "higher", "program_counter", "delivered_fps")
    assert m["layer"] == "kernels.sp_recon host compaction"
    assert m["workloads"] == ["sp1080_terminal_kmv_elided"]


@pytest.mark.parametrize("counters,want", [
    ({"elision.direct_rows": 110, "frames.scanned": 120,
      "rows.padded": 10}, 100.0),
    ({"elision.direct_rows": 55, "frames.scanned": 110}, 50.0),
    ({"frames.scanned": 120, "rows.padded": 10}, None),
    ({"elision.direct_rows": 0, "frames.scanned": 8, "rows.padded": 8},
     None),
    ({}, None),
])
def test_value(monkeypatch, counters, want):
    got = read(monkeypatch, counters)
    assert got == (pytest.approx(want) if want is not None else None)


def test_none_from_a_port_without_the_tracer(monkeypatch):
    from jsplayer_tpu_torch.utils import logging

    monkeypatch.delattr(logging, "TRACE")
    c = Context(cell=BENCH.cell("sp1080_terminal_kmv_elided"), spans=None,
                launches={}, trace=None, frames=200, window_s=1.0,
                coded_bytes=0, out_bytes=0)
    assert BENCH.module("metrics", "elision.direct_share").read(c) is None

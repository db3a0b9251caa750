"""The metrics that read the port's own tracer (portbench/program.py):
each gives its value from a fake TRACE.summary(), None when its span or
counter never ran, and None from a port without the tracer; and
span_idle.py's reductions of a Chrome trace."""

from __future__ import annotations

import numpy as np
import pytest

from portbench.harness import Context
from portbench.span_idle import (htod_bytes, idle_by_span, innermost,
                                 jsp_spans, reduce_trace)
from portbench.spec import CHECKOUT, Bench

BENCH = Bench(CHECKOUT)

SUMMARY = {
    "self_s": {"jsp.window": 0.01, "jsp.entropy": 0.2, "jsp.prep": 0.3,
               "jsp.upload": 0.4, "jsp.scan": 0.05, "jsp.epilogue": 0.02,
               "jsp.demux": 0.1, "jsp.compact": 0.5},
    "total_s": {"jsp.window": 2.0},
    "calls": {"jsp.window": 4},
    "counters": {"upload.bytes": 4_500_000 * 200, "frames.elided": 92,
                 "frames.timeline": 200, "frames.scanned": 120},
}

# metric -> its value from SUMMARY over 200 delivered frames
EXPECTED = {
    "window.self_ms_per_frame": 0.05,
    "entropy.self_ms_per_frame": 1.0,
    "prep.self_ms_per_frame": 1.5,
    "upload.self_ms_per_frame": 2.0,
    "scan.self_ms_per_frame": 0.25,
    "epilogue.self_ms_per_frame": 0.1,
    "upload.bytes_per_frame": 4_500_000.0,
    "elision.still_share": 46.0,
}


class FakeTracer:
    def __init__(self, summary):
        self._s = summary

    def summary(self):
        return self._s


def ctx(frames=200):
    return Context(cell=BENCH.cell("sp1080_terminal_kmv_elided"),
                   spans=None, launches={}, trace=None, frames=frames,
                   window_s=1.0, coded_bytes=0, out_bytes=0)


def read(name, c):
    return BENCH.module("metrics", name).read(c)


def test_every_program_metric_is_in_benchmark_json():
    names = {m["name"] for m in BENCH.spec["per_layer"]}
    assert set(EXPECTED) <= names
    for m in BENCH.spec["per_layer"]:
        if m["name"] in EXPECTED:
            assert m["moves"] == "delivered_fps" and m["workloads"]
            assert m["source"] == ("program_counter" if m["unit"] in
                                   ("B/frame", "%") else "program_span")


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_value_from_the_summary(monkeypatch, name):
    from jsplayer_tpu_torch.utils import logging

    monkeypatch.setattr(logging, "TRACE", FakeTracer(SUMMARY))
    assert read(name, ctx()) == pytest.approx(EXPECTED[name])
    if name.endswith("_per_frame"):
        assert read(name, ctx(frames=0)) is None


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_none_when_nothing_ran(monkeypatch, name):
    from jsplayer_tpu_torch.utils import logging

    empty = {"self_s": {}, "total_s": {}, "calls": {}, "counters": {}}
    monkeypatch.setattr(logging, "TRACE", FakeTracer(empty))
    assert read(name, ctx()) is None


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_none_from_a_port_without_the_tracer(monkeypatch, name):
    from jsplayer_tpu_torch.utils import logging

    monkeypatch.delattr(logging, "TRACE")
    assert read(name, ctx()) is None


def ev(cat, name, ts, dur, **args):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if args:
        e["args"] = args
    return e


def test_span_idle_reductions():
    events = [
        ev("user_annotation", "jsp.window", 1000.0, 5000.0),
        ev("user_annotation", "jsp.compact", 1200.0, 1000.0),
        ev("user_annotation", "jsp.upload", 3000.0, 500.0),
        ev("user_annotation", "portbench.window", 0.0, 9000.0),
        ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 3100.0, 300.0,
           bytes=4096),
        ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 9500.0, 10.0,
           bytes=999),  # after the window
        ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 4000.0, 10.0,
           bytes=7),
    ]
    spans = jsp_spans(events)
    assert [s[2] for s in spans] == ["jsp.window", "jsp.compact",
                                     "jsp.upload"]
    assert innermost(spans) == [
        (1000.0, 1200.0, "jsp.window"), (1200.0, 2200.0, "jsp.compact"),
        (2200.0, 3000.0, "jsp.window"), (3000.0, 3500.0, "jsp.upload"),
        (3500.0, 6000.0, "jsp.window")]
    assert htod_bytes(events, 0.0, 9000.0) == 4096
    gaps = np.array([[1300.0, 2100.0],    # compact, inside window
                     [2100.0, 2300.0],    # compact, then window alone
                     [2500.0, 2900.0],    # window alone
                     [3450.0, 3500.0],    # under 0.1 ms
                     [5900.0, 8500.0]])   # window, then no span
    got = idle_by_span(gaps, spans)
    assert got == pytest.approx({"jsp.compact": 900e-6, "jsp.window": 600e-6,
                                 "gaps under 0.1 ms": 50e-6,
                                 "no jsp span": 2500e-6})
    # the whole window: device busy 3100-3400 and 4000-4010 (us)
    red = reduce_trace(events)
    assert red["htod_bytes"] == 4096
    assert red["idle_s"] == pytest.approx((9000 - 310) / 1e6)
    assert red["idle_by_span"] == pytest.approx({
        "no jsp span": 4000e-6, "jsp.window": 3490e-6,
        "jsp.compact": 1000e-6, "jsp.upload": 200e-6})
    assert red["unlabelled_share"] == pytest.approx(4000 / 8690)
    assert red["trace_total_s"] == pytest.approx(
        {"jsp.window": 5e-3, "jsp.compact": 1e-3, "jsp.upload": 0.5e-3})

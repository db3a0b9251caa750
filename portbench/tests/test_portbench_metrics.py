"""The per-layer metrics' arithmetic on a synthetic trace, span record and
counters, and the span wrappers: a missing name leaves its metrics empty
(with a warning), never a failed run."""

from __future__ import annotations

import numpy as np
import pytest

from portbench.harness import Context
from portbench.spec import CHECKOUT, Bench
from portbench.trace import (Spans, _union, idle_gaps, label_gaps,
                             read_trace)

BENCH = Bench(CHECKOUT)


class FakeProf:
    """A profiler whose Chrome trace is given (ts and dur in us)."""

    def __init__(self, events):
        self.events = events

    def export_chrome_trace(self, path):
        import json

        with open(path, "w") as f:
            json.dump({"traceEvents": self.events}, f)


def ev(cat, name, ts, dur, card=0):
    """A Chrome trace event as Kineto writes it: a device event's pid is
    its card, which args.device names too."""
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": card, "args": {"device": card}}


TRACE = [
    ev("user_annotation", "portbench.window", 1000.0, 10000.0),
    ev("kernel", "kmv_compose", 900.0, 200.0),   # clipped to 100 us
    ev("kernel", "kmv_compose", 2000.0, 1000.0),
    ev("kernel", "ds2_pack", 2500.0, 1000.0),    # overlaps: union 2000-3500
    ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 5000.0, 500.0),
    ev("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 6000.0, 100.0),
    ev("gpu_memset", "Memset (Device)", 10900.0, 300.0),  # clipped: 100
    ev("cpu_op", "aten::add", 3000.0, 50.0),
]


class FakeSpans:
    def __init__(self, seconds):
        self._s = seconds
        self.records = []

    def seconds(self, s):
        return self._s.get(s)


def ctx(spans=None, launches=None, frames=100):
    tr = read_trace(FakeProf(TRACE))
    cell = BENCH.cell("sp1080_terminal_kmv_elided")
    return Context(cell=cell, spans=spans or FakeSpans({}),
                   launches=launches or {}, trace=tr, frames=frames,
                   window_s=0.01, coded_bytes=1_000_000,
                   out_bytes=2_350_000_000)


def read(name, c):
    return BENCH.module("metrics", name).read(c)


def test_trace_reduction():
    c = ctx()
    assert c.trace["w0"] == 1000.0 and c.trace["w1"] == 11000.0
    np.testing.assert_allclose(
        c.trace["busy"], [[1000, 1100], [2000, 3500], [5000, 5500],
                          [6000, 6100], [10900, 11000]])
    assert c.device_seconds(cats=("kernel",)) == pytest.approx(2100e-6)
    assert c.device_seconds(cats=("gpu_memcpy",), name_has="HtoD") == \
        pytest.approx(500e-6)
    gaps = idle_gaps(c.trace["busy"], c.trace["w0"], c.trace["w1"])
    np.testing.assert_allclose(gaps, [[1100, 2000], [3500, 5000],
                                      [5500, 6000], [6100, 10900]])
    np.testing.assert_allclose(_union(np.array([[3., 4.], [1., 2.5],
                                                [2., 3.]])), [[1, 4]])


def test_busy_by_card():
    """Each device event keeps its card (args.device, else the pid): busy
    time by card, beside the merged busy time of every card."""
    other = [ev("kernel", "kmv_compose", 2000.0, 3000.0, card=2),
             ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 8000.0,
                400.0, card=2)]
    del other[1]["args"]["device"]  # the pid alone names the card
    one = ctx()
    assert set(one.trace["busy_by_card"]) == {0}
    np.testing.assert_allclose(one.trace["busy_by_card"][0],
                               one.trace["busy"])
    assert one.card_busy_seconds() == pytest.approx({0: 2300e-6})
    two = Context(**{**one.__dict__,
                     "trace": read_trace(FakeProf(TRACE + other))})
    assert list(two.trace["card"]) == [0] * 6 + [2, 2]
    assert two.card_busy_seconds() == pytest.approx({0: 2300e-6,
                                                     2: 3400e-6})
    np.testing.assert_allclose(
        two.trace["busy"], [[1000, 1100], [2000, 5500], [6000, 6100],
                            [8000, 8400], [10900, 11000]])


def test_metric_arithmetic():
    c = ctx(spans=FakeSpans({"ingest": 0.5, "native": 0.2,
                             "elision": 0.1}),
            launches={"a": 150, "b": 50})
    assert read("ingest.host_ms_per_frame", c) == pytest.approx(5.0)
    assert read("native.decode_ms_per_frame", c) == pytest.approx(2.0)
    assert read("elision.compact_ms_per_frame", c) == pytest.approx(1.0)
    assert read("device.h2d_ms_per_frame", c) == pytest.approx(0.005)
    assert read("kernels.launches_per_frame", c) == pytest.approx(2.0)
    # (1e6 + 2.35e9) bytes at 3.35e12 B/s = 0.0007018 s over 0.0021 s
    assert read("kernels_roofline", c) == pytest.approx(
        100 * 2.351e9 / 3.35e12 / 2100e-6)
    busy = 100 + 1500 + 500 + 100 + 100
    assert read("device.idle_share", c) == pytest.approx(
        100 * (1 - busy / 10000))


def test_nothing_to_read_gives_none():
    c = ctx(spans=FakeSpans({}), launches={})
    for name in ("ingest.host_ms_per_frame", "native.decode_ms_per_frame",
                 "elision.compact_ms_per_frame",
                 "kernels.launches_per_frame"):
        assert read(name, c) is None
    empty = Context(**{**ctx().__dict__, "trace": read_trace(
        FakeProf(TRACE[:1]))})
    assert read("kernels_roofline", empty) is None  # never 0 for a share


def test_spans_wrap_time_and_unwrap(tmp_path, capsys):
    import json
    import shutil

    co = tmp_path / "co"
    shutil.copytree(CHECKOUT + "/portbench/spans", co / "portbench" / "spans")
    shutil.copy(CHECKOUT + "/BENCHMARK.json", co)
    with open(co / "portbench" / "spans" / "elision.json") as f:
        s = json.load(f)
    s["names"].append("jsplayer_tpu_torch.kernels.sp_recon:no_such_fn")
    with open(co / "portbench" / "spans" / "elision.json", "w") as f:
        json.dump(s, f)
    from jsplayer_tpu_torch.kernels import sp_recon

    raw = sp_recon.compact_changed_batch
    spans = Spans(Bench(str(co)), ["elision", "ingest"])
    spans.install()
    try:
        assert sp_recon.compact_changed_batch is not raw
        pc = np.zeros((2, 4, 8, 8), np.uint32)
        mvk = np.zeros((2, 4, 2, 2), np.int32)
        out = sp_recon.compact_changed_batch(pc, mvk,
                                             np.ones((2, 4), bool))
        assert out[0].shape[:2] == (2, 4)
    finally:
        spans.uninstall()
    assert sp_recon.compact_changed_batch is raw
    assert "no_such_fn" in capsys.readouterr().err
    assert spans.seconds("elision") is None  # broken set: no metric
    assert spans.seconds("ingest") is None  # never ran
    assert [r[:2] for r in spans.records] == [("elision",
                                               "compact_changed_batch")]


def test_gap_labels():
    class S:
        records = [("ingest", "_decode_window", 0, 9_000_000),
                   ("native", "decompress_kmv", 1_000_000, 2_000_000)]

    gaps = np.array([[1000.0, 2000.0], [5000.0, 5050.0], [9500, 9900]])
    got = label_gaps(gaps, S, offset_us=0.0)
    assert got == pytest.approx({"native:decompress_kmv": 1e-3,
                                 "gaps under 0.1 ms": 50e-6,
                                 "outside spans": 400e-6})

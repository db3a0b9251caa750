"""The port's tracer (jsplayer_tpu_torch.utils.logging.TRACE) and the
ingest pipeline's spans and counters, on the CPU.

With no profiler recording, the pipeline opens no span and never enters
torch.profiler.record_function.  Under torch.profiler (CPU activity) over
three small batches (SP stills through the elided kmv path, MSVideo1, lane
containers still-elided): every jsp.* span is in the exported Chrome
trace, and every one but jsp.demux lies inside a jsp.window; self times
are >= 0 and add up to jsp.window's total; each window's stills kept out
plus its real scanned rows are its timeline frames; upload.bytes is what
was handed to to_device and to_device_into; and the windows equal those
of a run with tracing off, bit for bit.
"""

import json

import numpy as np
import pytest
import torch

from jsplayer_tpu_torch import device as port_device
from jsplayer_tpu_torch.core.source import MemorySource
from jsplayer_tpu_torch.kernels import lane_transport, rans_lanes
from jsplayer_tpu_torch.pipeline import ingest as P
from jsplayer_tpu_torch.pipeline import mesh as port_mesh
from jsplayer_tpu_torch.transcode import transcode_to_lane
from jsplayer_tpu_torch.utils import logging as L
from test_ingest import _check_elided_stream, msv1_avi, sp_avi_stills
from test_lane_container import make_avi
from test_torch_ingest import assert_windows_equal

torch.set_num_threads(1)


def _sp():
    return [sp_avi_stills(s)[0] for s in (3, 7)], dict(
        window=6, still_elision=True)


def _msv1():
    return [msv1_avi(s)[0] for s in (1, 2)], dict(window=4)


def _lane():
    return [transcode_to_lane(make_avi(s, 64, 48, 14, key_every=5)[0],
                              window=4, K=2, payload="rans")
            for s in range(2)], dict(sp_device_path="lane",
                                     still_elision=True)


BATCHES = {"sp_kmv_elided": _sp, "msv1": _msv1, "lane_elided": _lane}
SPANS = {
    "sp_kmv_elided": {"jsp.demux", "jsp.window", "jsp.entropy",
                      "jsp.compact", "jsp.prep", "jsp.upload", "jsp.scan",
                      "jsp.epilogue"},
    "msv1": {"jsp.demux", "jsp.window", "jsp.entropy", "jsp.prep",
             "jsp.upload", "jsp.scan", "jsp.epilogue"},
    "lane_elided": {"jsp.demux", "jsp.window", "jsp.compact", "jsp.prep",
                    "jsp.upload", "jsp.scan", "jsp.epilogue"},
}
ELIDED = {"sp_kmv_elided", "lane_elided"}
# every module that binds to_device (or to_device_into) by name
UPLOADERS = (P, lane_transport, rans_lanes, port_mesh)


def run(sources, kw):
    pipe = P.VideoIngestPipeline([MemorySource(s) for s in sources],
                                 P.IngestConfig(device="cpu", **kw))
    return list(pipe)


def test_tracer_spans_self_times_and_sessions(monkeypatch):
    """Nested spans on a Tracer of its own: calls, totals, self times,
    window ids inherited from the parent, the raw records; a session starts
    when the profiler is first seen on, and its counters are what it added
    to the Log's."""
    on = [False]
    monkeypatch.setattr(torch.autograd, "_profiler_enabled", lambda: on[0])
    log = L.Log()
    log.count("before", 5)
    tr = L.Tracer(log)
    assert tr.poll() is False and tr.span("jsp.x") is L._NO_SPAN
    on[0] = True
    assert tr.poll() is True
    with tr.span("jsp.window", (0, 16)):
        with tr.span("jsp.scan"):
            assert tr.window() == (0, 16)
            with tr.span("jsp.upload"):
                log.count("upload.bytes", 100)
        with tr.span("jsp.upload"):
            log.count("upload.bytes", 20)
    assert tr.window() is None
    s = tr.summary()
    assert s["calls"] == {"jsp.window": 1, "jsp.scan": 1, "jsp.upload": 2}
    assert s["counters"] == {"upload.bytes": 120}
    assert all(v >= 0 for v in s["self_s"].values())
    assert sum(s["self_s"].values()) == pytest.approx(
        s["total_s"]["jsp.window"], rel=1e-9)
    dur = {r[0]: (r[4] - r[3]) / 1e9 for r in tr.records[:2]}
    assert s["self_s"]["jsp.scan"] == pytest.approx(
        dur["jsp.scan"] - dur["jsp.upload"], abs=1e-9)
    assert [(r[0], r[1], r[2]) for r in tr.records] == [
        ("jsp.upload", (0, 16), "jsp.scan"),
        ("jsp.scan", (0, 16), "jsp.window"),
        ("jsp.upload", (0, 16), "jsp.window"),
        ("jsp.window", (0, 16), None)]
    # still on: the same session
    tr.poll()
    assert tr.summary()["calls"]["jsp.window"] == 1
    # off, then on again: a new session, counted from there
    on[0] = False
    tr.poll()
    assert tr.summary()["calls"]["jsp.window"] == 1  # kept while off
    log.count("upload.bytes", 7)
    on[0] = True
    tr.poll()
    log.count("upload.bytes", 3)
    assert tr.summary() == {"self_s": {}, "total_s": {}, "calls": {},
                            "counters": {"upload.bytes": 3}}


def test_record_cap(monkeypatch):
    monkeypatch.setattr(torch.autograd, "_profiler_enabled", lambda: True)
    monkeypatch.setattr(L, "MAX_RECORDS", 3)
    tr = L.Tracer(L.Log())
    tr.poll()
    for _ in range(5):
        with tr.span("jsp.prep"):
            pass
    assert len(tr.records) == 3 and tr.summary()["calls"]["jsp.prep"] == 5


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_off_opens_no_span(monkeypatch, name):
    """No profiler: no span is recorded and record_function is never
    entered."""
    def boom(*a, **k):
        raise AssertionError("record_function entered with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    sources, kw = BATCHES[name]()
    stats, n = dict(L.TRACE.stats), len(L.TRACE.records)
    assert run(sources, kw)
    assert not L.TRACE.active
    assert L.TRACE.stats == stats and len(L.TRACE.records) == n


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_traced_run(monkeypatch, tmp_path, name):
    sources, kw = BATCHES[name]()
    plain = run(sources, kw)

    sent = []  # nbytes handed to to_device and to_device_into
    by_window: dict = {}  # window id -> counter -> n
    raw_put, raw_count = port_device.to_device, L.LOG.count
    raw_into = port_device.to_device_into

    def put(a, device):
        sent.append(np.ascontiguousarray(a).nbytes)
        return raw_put(a, device)

    def put_into(a, out):
        sent.append(np.ascontiguousarray(a).nbytes)
        return raw_into(a, out)

    def count(key, n=1):
        w = L.TRACE.window()
        if w is not None:
            c = by_window.setdefault(w, {})
            c[key] = c.get(key, 0) + n
        raw_count(key, n)

    for mod in UPLOADERS:
        monkeypatch.setattr(mod, "to_device", put)
        if hasattr(mod, "to_device_into"):
            monkeypatch.setattr(mod, "to_device_into", put_into)
    monkeypatch.setattr(L.LOG, "count", count)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        traced = run(sources, kw)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    summary = L.TRACE.summary()

    # the windows: bit for bit those of the run with tracing off
    assert_windows_equal(plain, traced)

    # every span in the Chrome trace, all but demux inside a jsp.window
    with open(tmp_path / "trace.json") as f:
        ev = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"
              and str(e.get("name", "")).startswith("jsp.")]
    names = {e["name"] for e in ev}
    assert names == SPANS[name] == set(summary["calls"])
    for n in names:
        assert sum(e["name"] == n for e in ev) == summary["calls"][n]
    wins = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in ev if e["name"] == "jsp.window"]
    assert len(wins) == len(by_window) == summary["calls"]["jsp.window"]
    for e in ev:
        if e["name"] in ("jsp.window", "jsp.demux"):
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        assert any(w0 <= a and b <= w1 for w0, w1 in wins), e

    # self times: >= 0, adding up to the windows' total
    assert all(v >= 0 for v in summary["self_s"].values())
    inside = sum(v for k, v in summary["self_s"].items() if k != "jsp.demux")
    assert inside == pytest.approx(summary["total_s"]["jsp.window"],
                                   rel=1e-9)
    assert summary["self_s"]["jsp.demux"] == summary["total_s"]["jsp.demux"]

    # each window's counters against what it handed out: a changed frame
    # of an elided window owns a row of the flat stack (its distinct outmap
    # values), a still aliases one; stills kept out + real scanned rows =
    # timeline frames
    B = len(sources)
    nframes = {"sp_kmv_elided": 12, "msv1": 11, "lane_elided": 14}[name]
    assert sorted(w[1] for w in by_window) == [w["start_frame"]
                                               for w in traced]
    for w in traced:
        c = by_window[next(k for k in by_window if k[1] == w["start_frame"])]
        if name in ELIDED:
            om = np.asarray(w["outmap"])
            n = om.shape[1]
            changed = sum(len(set(om[b][om[b] >= 0])) for b in range(B))
            scanned = w["frames_u32"].shape[0]
            assert c.get("frames.elided", 0) == B * n - changed
        else:
            n = min(w["frames_u32"].shape[1], nframes - w["start_frame"])
            changed = B * n
            scanned = B * kw["window"]
            assert "frames.elided" not in c
        assert c["frames.timeline"] == B * n
        assert c["frames.scanned"] == scanned
        assert c.get("rows.padded", 0) == scanned - changed
        assert c.get("frames.elided", 0) + scanned - c.get(
            "rows.padded", 0) == c["frames.timeline"]
    ctr = summary["counters"]
    assert ctr["frames.timeline"] == sum(
        c["frames.timeline"] for c in by_window.values())
    assert ctr["frames.timeline"] == B * nframes
    if name in ELIDED:
        assert 0 < ctr["frames.elided"] < ctr["frames.timeline"]
    else:
        assert "frames.elided" not in ctr

    # the upload counter is the bytes handed to to_device and
    # to_device_into
    assert ctr["upload.bytes"] == sum(sent) > 0
    assert ctr["upload.calls"] == len(sent)
    assert summary["calls"]["jsp.upload"] == len(sent)


# -- the mesh's spans and counters (pipeline/mesh.run_bg, run_rows) ----------

MESH_COUNTERS = ("mesh.dispatches", "mesh.slot_launches",
                 "mesh.exchange_bytes")


def _sp_mesh():
    avis, golds = zip(*(sp_avi_stills(s) for s in (3, 7, 11, 13)))
    return avis, golds, dict(window=6, still_elision=True,
                             emit_model_input=True, model_downscale=2)


def _lane_mesh():
    return [transcode_to_lane(make_avi(s, 64, 48, 12, key_every=3)[0],
                              window=3, K=2, payload="raw")
            for s in range(4)], None, dict(sp_device_path="lane",
                                           still_elision=True)


def mesh_run(sources, kw):
    """The batch on a dp=4 mesh of four CPU slots → (windows, what the run
    added to the mesh's LOG counters)."""
    m = port_mesh.make_mesh(4, 1, devices=[torch.device("cpu")] * 4)
    before = {k: L.LOG.counters[k] for k in MESH_COUNTERS}
    pipe = P.VideoIngestPipeline([MemorySource(s) for s in sources],
                                 P.IngestConfig(device="cpu", mesh=m, **kw))
    out = list(pipe)
    return out, {k: L.LOG.counters[k] - before[k] for k in MESH_COUNTERS}


def expected_exchange(windows, B=4, dp=4) -> int:
    """mesh.exchange_bytes worked out from the windows' shapes: in each
    window's dispatch every slot but the gather slot receives its streams'
    carry-in frames and returns its [B/dp, Cpad] rows, 4 bytes a pixel."""
    moved = 0
    for w in windows:
        rows, Y, X = w["frames_u32"].shape
        moved += (B - B // dp) * (1 + rows // B) * Y * X * 4
    return moved


@pytest.mark.parametrize("make,step", [(_sp_mesh, "run_bg"),
                                       (_lane_mesh, "run_rows")],
                         ids=["kmv_elided", "lane_elided"])
def test_mesh_spans_and_counters(monkeypatch, make, step):
    """Untraced: no span opens.  Traced: jsp.shard and jsp.gather open once
    a dispatch, inside jsp.scan; a dispatch a window, four slot
    launches each, and the exchange bytes the windows' shapes give; the
    windows equal the untraced run's bit for bit (and, kmv, the source
    frames)."""
    sources, golds, kw = make()
    calls = []
    raw_step = getattr(port_mesh, step)

    def seen(*a, **k):
        calls.append(1)
        return raw_step(*a, **k)

    monkeypatch.setattr(port_mesh, step, seen)
    if step == "run_bg":
        from jsplayer_tpu_torch.pipeline import batch

        monkeypatch.setattr(batch, "run_bg", seen)

    def boom(*a, **k):
        raise AssertionError("record_function entered with tracing off")

    with monkeypatch.context() as mp:
        mp.setattr(torch.profiler, "record_function", boom)
        mp.setattr(torch.autograd.profiler, "record_function", boom)
        stats, n = dict(L.TRACE.stats), len(L.TRACE.records)
        plain, off = mesh_run(sources, kw)
        assert not L.TRACE.active
        assert L.TRACE.stats == stats and len(L.TRACE.records) == n

    n_plain = len(calls)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        traced, on = mesh_run(sources, kw)
    s = L.TRACE.summary()
    assert_windows_equal(plain, traced)
    if golds is not None:
        for b, gold in enumerate(golds):
            _check_elided_stream(traced, gold, b)
        assert all("model_input" in w for w in traced)

    # a dispatch a window
    dispatches, moved = len(traced), expected_exchange(traced)
    assert len(calls) == 2 * n_plain == 2 * dispatches
    assert on == off == {"mesh.dispatches": dispatches,
                         "mesh.slot_launches": 4 * dispatches,
                         "mesh.exchange_bytes": moved}
    assert {k: s["counters"][k] for k in MESH_COUNTERS} == on
    assert s["calls"]["jsp.shard"] == s["calls"]["jsp.gather"] == dispatches
    for span in ("jsp.shard", "jsp.gather"):
        parents = {r[2] for r in L.TRACE.records if r[0] == span}
        assert parents == {"jsp.scan"}, (span, parents)
    # the slots' uploads are the shard's children (kmv: the planes)
    up = {r[2] for r in L.TRACE.records if r[0] == "jsp.upload"}
    assert "jsp.shard" in up


def test_mesh_elided_rows_upload_straight_from_the_window(monkeypatch):
    """Still elision on a dp=4 mesh of four CPU slots: every real scanned
    row goes from the pooled window straight to its slot
    (elision.direct_rows = frames.scanned - rows.padded); upload.bytes is
    those rows' planes and the small arrays handed to to_device, none of
    them a plane, so no pad row is uploaded; mesh.exchange_bytes is the
    carries and results the windows' shapes give; the frames are the
    sources'."""
    sources, golds, kw = _sp_mesh()
    put = []
    for mod in (P, port_mesh):
        def to_dev(a, device, raw=mod.to_device):
            put.append(np.asarray(a))
            return raw(a, device)

        monkeypatch.setattr(mod, "to_device", to_dev)
    before = L.LOG.counters.copy()
    windows, moved = mesh_run(sources, kw)
    got = L.LOG.counters - before
    for b, gold in enumerate(golds):
        _check_elided_stream(windows, gold, b)

    Y, X = windows[0]["frames_u32"].shape[1:]
    direct = got["elision.direct_rows"]
    assert got["rows.padded"] > 0 and direct > 0
    assert direct == got["frames.scanned"] - got["rows.padded"]
    assert all(a.shape[-2:] != (Y, X) for a in put)
    assert got["upload.calls"] == got["elision.direct_runs"] + len(put)
    assert got["upload.bytes"] == (direct * Y * X * 4
                                   + sum(a.nbytes for a in put))
    assert moved["mesh.exchange_bytes"] == expected_exchange(windows)

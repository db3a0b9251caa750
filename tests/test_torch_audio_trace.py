"""The MP3 demux in the port's tracer: StreamReader's jsp.audio span and
its counters audio.frames, audio.bytes and audio.sections, on the CPU.

Under torch.profiler (CPU activity), a batch of two 8-bit palettized
MSVideo1 streams with MP3 tracks (BASELINE config 2's shape) opens one
jsp.audio span a stream in the up-front drain, each a child of jsp.demux,
whose self time then leaves it out; streaming, each parse of the pump
opens one inside the pump's jsp.demux.  The counters equal the MP3 frames
and bytes that a plain RIFF walk finds in the containers' 01wb chunks, and
the sections the parsers handed to the tracks.  The windows and the tracks
equal those of a run with tracing off, which opens no span and counts
nothing, and the tracks the reference's.
"""

import struct

import numpy as np
import pytest
import torch

from jsplayer_tpu.core.source import MemorySource
from jsplayer_tpu.pipeline import ingest as J
from jsplayer_tpu_torch.pipeline import ingest as P
from jsplayer_tpu_torch.utils import logging as L
from test_torch_host_copies import plain
from test_torch_ingest import assert_windows_equal
from test_torch_msv1 import msv1_8_avi

torch.set_num_threads(1)

COUNTERS = ("audio.frames", "audio.bytes", "audio.sections")
MODES = {"upfront": dict(window=4), "streaming": dict(window=3,
                                                      streaming=True)}


def _chunks(data: bytes, at: int, end: int):
    while at + 8 <= end:
        tag, n = struct.unpack_from("<4sI", data, at)
        yield tag, at + 8, n
        at += 8 + n + (n & 1)


def sound_bytes(avi: bytes) -> bytes:
    """The payloads of the movi list's 01wb chunks, in order."""
    out = []
    for tag, at, n in _chunks(avi, 12, len(avi)):
        if tag == b"LIST" and avi[at:at + 4] == b"movi":
            out += [avi[a:a + m] for t, a, m in _chunks(avi, at + 4, at + n)
                    if t == b"01wb"]
    return b"".join(out)


def mp3_frames(data: bytes) -> list:
    """MPEG-1 Layer III frames split by their headers alone (ISO/IEC
    11172-3: 144 x bitrate / rate bytes, plus the padding byte)."""
    kbps = [0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320]
    rates = [44100, 48000, 32000]
    out, at = [], 0
    while at < len(data):
        h = int.from_bytes(data[at:at + 4], "big")
        assert h >> 21 == 0x7FF and (h >> 17) & 0xF == 0xD  # MPEG-1 L3
        n = (144000 * kbps[(h >> 12) & 15] // rates[(h >> 10) & 3]
             + ((h >> 9) & 1))
        out.append(data[at:at + n])
        at += n
    assert at == len(data)
    return out


def run(avis, kw):
    pipe = P.VideoIngestPipeline([MemorySource(a) for a in avis],
                                 P.IngestConfig(device="cpu", **kw))
    return pipe, list(pipe)


@pytest.mark.parametrize("n_mp3", [40, 450])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_audio_span_and_counters(mode, n_mp3):
    """40 MP3 frames a stream give the track one section; 450 cross the
    parser's 200-frame short sections twice (4 frames overlapping), so
    three sections go to a track that keeps one."""
    kw = MODES[mode]
    avis = [msv1_8_avi(s, audio=True, mp3_frames=n_mp3) for s in (1, 2)]
    plain_pipe, plain_windows = run(avis, kw)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        pipe, windows = run(avis, kw)
    s = L.TRACE.summary()
    assert_windows_equal(plain_windows, windows)
    assert plain(pipe.audio_tracks) == plain(plain_pipe.audio_tracks)

    recs = [r for r in L.TRACE.records if r[0] == "jsp.audio"]
    assert recs and all(r[2] == "jsp.demux" for r in recs)
    assert len(recs) == s["calls"]["jsp.audio"]
    if mode == "upfront":  # one drain a stream
        assert len(recs) == len(avis)
    assert s["self_s"]["jsp.demux"] == pytest.approx(
        s["total_s"]["jsp.demux"] - s["total_s"]["jsp.audio"], rel=1e-9)

    frames = [mp3_frames(sound_bytes(a)) for a in avis]
    assert [len(f) for f in frames] == [n_mp3] * 2
    c = s["counters"]
    assert c["audio.frames"] == sum(len(f) for f in frames)
    assert c["audio.bytes"] == sum(len(x) for f in frames for x in f)
    added = sum(len(r.loader.mp3_parser.sections) for r in pipe.readers)
    kept = sum(len(t.sections) for t in pipe.audio_tracks)
    assert c["audio.sections"] == added
    assert (added, kept) == ((2, 2) if n_mp3 == 40 else (6, 2))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_untraced_run_opens_no_audio_span(monkeypatch, mode):
    """Tracing off: no span, no audio counter, and the windows and tracks
    of a traced run; the tracks the reference's."""
    kw = MODES[mode]
    avis = [msv1_8_avi(s, audio=True) for s in (1, 2)]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        traced_pipe, traced = run(avis, kw)

    def boom(*a, **k):
        raise AssertionError("record_function entered with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    before = {k: L.LOG.counters[k] for k in COUNTERS}
    pipe, windows = run(avis, kw)
    assert not L.TRACE.active
    assert {k: L.LOG.counters[k] for k in COUNTERS} == before
    assert_windows_equal(traced, windows)
    assert plain(pipe.audio_tracks) == plain(traced_pipe.audio_tracks)
    jp = J.VideoIngestPipeline([MemorySource(a) for a in avis],
                               J.IngestConfig(**kw))
    list(jp)
    assert plain(pipe.audio_tracks) == plain(jp.audio_tracks)
    assert all(t.sections for t in pipe.audio_tracks)


def test_no_sound_no_audio_span():
    """A source without sound chunks parses no MP3: no jsp.audio span."""
    avis = [msv1_8_avi(s) for s in (1, 2)]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        run(avis, MODES["upfront"])
    s = L.TRACE.summary()
    assert "jsp.demux" in s["calls"] and "jsp.audio" not in s["calls"]
    assert not set(COUNTERS) & set(s["counters"])

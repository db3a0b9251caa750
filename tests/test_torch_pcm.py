"""The port's MP3 → PCM path (jsplayer_tpu_torch.av.pcm over its own
native/ffshim build) against the JAX package's, on the CPU.

Twins of tests/test_pcm.py: the same MP3 bytes decode to the same samples
and sample rate, tracks assemble to AlignedPcm objects with equal fields
(samples bit for bit, rate, channels, duration) and equal slices; and
``VideoIngestPipeline.audio_pcm`` of the two pipelines agrees on AVI
sources, streaming sources and lane containers (the audio passthrough of
tests/test_lane_container.py).  Gated, as the reference's tests are, on
the system codec library."""

import numpy as np
import pytest

import jsplayer_tpu_torch as PT
from jsplayer_tpu.av import pcm as JP
from jsplayer_tpu.core.source import MemorySource as JMem
from jsplayer_tpu.encode.avi_mux import mux_avi
from jsplayer_tpu.encode.mp3_synth import make_silence_frames
from jsplayer_tpu.pipeline.ingest import IngestConfig as JCfg
from jsplayer_tpu.pipeline.ingest import VideoIngestPipeline as JPipe
from jsplayer_tpu.transcode import transcode_to_lane
from jsplayer_tpu_torch.av import pcm as PP
from jsplayer_tpu_torch.core.source import MemorySource as PMem
from jsplayer_tpu_torch.pipeline.ingest import IngestConfig as PCfg
from jsplayer_tpu_torch.pipeline.ingest import VideoIngestPipeline as PPipe
from test_torch_player import silent_av_avi

pytestmark = pytest.mark.skipif(
    not (JP.available() and PP.available()),
    reason="system libavcodec not available")


def aligned(a):
    """An AlignedPcm (or None) → plain comparable fields."""
    if a is None:
        return None
    return (a.samples.dtype.str, a.samples.shape, a.samples.tobytes(),
            a.sample_rate, a.channels, a.duration)


@pytest.mark.parametrize("kw", [dict(), dict(stereo=True),
                                dict(sampling_idx=1), dict(sampling_idx=2)])
def test_fragment_decode_matches_reference(kw):
    data, n, rate = make_silence_frames(10, **kw)
    (sj, rj), (sp, rp) = JP.decode_fragment(data), PP.decode_fragment(data)
    assert rp == rj == rate
    assert sp.dtype == sj.dtype == np.float32
    assert sp.shape == sj.shape == (n * 1152, sj.shape[1])
    np.testing.assert_array_equal(sp, sj)


def track_of(pkg, data):
    """data → an AudioTrack of `pkg`'s own parser (its copies of
    ChunkBuffer, Mp3Parser and AudioTrack)."""
    import importlib

    cb = importlib.import_module(f"{pkg}.core.chunkbuffer")
    mp3 = importlib.import_module(f"{pkg}.av.mp3")
    at = importlib.import_module(f"{pkg}.av.audio_track")
    buf = cb.ChunkBuffer()
    buf.add_chunk(data)
    p = mp3.Mp3Parser(buf)
    p.parse()
    p.on_data_end()
    p.parse()
    track = at.AudioTrack()
    for s in p.sections:
        track.add_section(s)
    return track


@pytest.mark.parametrize("nframes", [1, 60, 2 * 160 + 50])
def test_track_assembly_matches_reference(nframes):
    """Sections overlap by 4 frames; the aligned timeline collapses the
    overlap to exactly nframes * 1152 samples in both."""
    data, _, rate = make_silence_frames(nframes)
    tj, tp = track_of("jsplayer_tpu", data), track_of("jsplayer_tpu_torch",
                                                       data)
    aj, ap = JP.decode_track(tj), PP.decode_track(tp)
    assert aligned(ap) == aligned(aj)
    assert ap.sample_rate == rate and ap.samples.shape[0] == nframes * 1152
    assert ap.duration == pytest.approx(tp.time_loaded, abs=1e-6)
    for t0, t1 in ((0.0, 0.1), (0.05, 0.5), (-1.0, 99.0), (0.3, 0.2)):
        np.testing.assert_array_equal(ap.slice_seconds(t0, t1),
                                      aj.slice_seconds(t0, t1))
        assert ap.sample_index(t0) == aj.sample_index(t0)


def test_empty_and_missing_tracks_match_reference():
    from jsplayer_tpu.av.audio_track import AudioTrack as JTrack
    from jsplayer_tpu_torch.av.audio_track import AudioTrack as PTrack

    assert PP.decode_track(PTrack()) is None is JP.decode_track(JTrack())
    assert PP.decode_tracks([PTrack()]) == [None] == \
        JP.decode_tracks([JTrack()])


def av_avi():
    """tests/test_pcm.py's A/V AVI: 8 MSV1 frames at 15 fps, 25 MP3
    frames in two sound chunks."""
    from jsplayer_tpu.codecs.msvideo1 import from_rgb15
    from jsplayer_tpu.encode.msv1_enc import encode_frame_16

    W, H, fps = 32, 24, 15.0
    rng = np.random.default_rng(5)
    prev, pkts = None, []
    for i in range(8):
        f = np.full(W * H, from_rgb15(0x0421), dtype=np.uint32)
        f[: W * (i + 1)] = from_rgb15(int(rng.integers(0, 0x8000)))
        pkts.append(encode_frame_16(f, prev, W, H))
        prev = f
    mp3, n_mp3, rate = make_silence_frames(25)
    half = len(mp3) // 2
    return mux_avi(pkts, W, H, 16, codec="CRAM", fps=fps,
                   keyflags=[i == 0 for i in range(8)],
                   sound_chunks=[(0, mp3[:half]), (4, mp3[half:])]), n_mp3


def test_av_ingest_alignment_matches_reference():
    """Both pipelines on the same A/V AVI: the video windows, then
    audio_pcm's AlignedPcm (cached on the second call) and every window's
    slice_for_frames equal to the reference's."""
    avi, n_mp3 = av_avi()
    jp = JPipe([JMem(avi)], JCfg(window=4))
    pp = PPipe([PMem(avi)], PCfg(window=4, device="cpu"))
    assert len(list(pp)) == len(list(jp)) == 2
    (aj,), (ap,) = jp.audio_pcm(), pp.audio_pcm()
    assert aligned(ap) == aligned(aj)
    assert ap.samples.shape[0] == n_mp3 * 1152
    assert pp.audio_pcm()[0] is ap
    for f0 in (0, 4, 40):
        np.testing.assert_array_equal(ap.slice_for_frames(f0, 4, 15.0),
                                      aj.slice_for_frames(f0, 4, 15.0))


def test_streaming_audio_pcm_matches_reference():
    """tests/test_streaming_ingest.py's A/V stream through the streaming
    demux of both pipelines (512-byte network chunks)."""
    from test_streaming_ingest import SmallChunkSource, long_sp_avi

    class PSmall(PMem):
        def stream_range(self, start, end=None, chunk_size=1 << 16):
            return super().stream_range(start, end, chunk_size=512)

    avi = long_sp_avi(5, nframes=48, with_sound=True)
    jp = JPipe([SmallChunkSource(avi)], JCfg(window=8, streaming=True))
    pp = PPipe([PSmall(avi)], PCfg(window=8, streaming=True, device="cpu"))
    list(jp), list(pp)
    (aj,), (ap,) = jp.audio_pcm(), pp.audio_pcm()
    assert aligned(ap) == aligned(aj)
    assert ap.samples.shape[0] == 40 * 1152


@pytest.mark.parametrize("window", [3, 4])
def test_lane_audio_passthrough_matches_reference(window):
    """The lane container carries the AVI's MP3 stream: the port's lane
    pipeline rebuilds the reference's section timeline and decodes the
    same samples, equal to both AVI pipelines'; a container without audio
    has None tracks in both."""
    avi = silent_av_avi(n=6)
    cont = transcode_to_lane(avi, window=window, K=2)
    jl = JPipe([JMem(cont)], JCfg(sp_device_path="lane"))
    pl = PPipe([PMem(cont)], PCfg(sp_device_path="lane", device="cpu"))
    pa = PPipe([PMem(avi)], PCfg(window=window, device="cpu"))
    (lt,), (jt,), (at,) = pl.audio_tracks, jl.audio_tracks, pa.audio_tracks
    assert lt.time_loaded == jt.time_loaded == at.time_loaded
    assert len(lt.sections) == len(jt.sections) == len(at.sections)
    (lp,), (lj,), (ap,) = pl.audio_pcm(), jl.audio_pcm(), pa.audio_pcm()
    assert aligned(lp) == aligned(lj) == aligned(ap)
    assert lp is not None
    bare = PT.transcode_to_lane(silent_av_avi(n=6, mp3_frames=0),
                                window=window, K=2)
    pipes = (JPipe([JMem(bare)], JCfg()), PPipe([PMem(bare)],
                                                 PCfg(device="cpu")))
    assert [p.audio_tracks for p in pipes] == [[None], [None]]
    # the reference's audio_pcm raises on such a container (decode_tracks
    # takes a None track for an AudioTrack: ROADMAP §3 reference fault 8),
    # and the port's copy of av/pcm.py mirrors it
    for p in pipes:
        with pytest.raises(AttributeError, match="sections"):
            p.audio_pcm()

"""The port's lane-container ingest (VideoIngestPipeline with
sp_device_path="lane", device="cpu": the plain twins) against the JAX
package's pipeline on the same containers, window dict by window dict, bit
for bit: raw and rans payloads, dense and still-elided, ds2 model tensors,
16 bpp, ragged keyframe-snapped windows, frame_range clips, audio
passthrough and auto-detection without the flag; and the errors the
reference raises."""

import numpy as np
import pytest
import torch

from jsplayer_tpu.core.source import MemorySource
from jsplayer_tpu.encode.avi_mux import mux_avi
from jsplayer_tpu.encode.sp_enc import ScreenPressorEncoder
from jsplayer_tpu.pipeline import ingest as J
from jsplayer_tpu.transcode import transcode_to_lane
from jsplayer_tpu_torch.pipeline import ingest as P
from test_lane_container import make_avi, make_stream
from test_torch_ingest import assert_windows_equal

torch.set_num_threads(1)

X, Y, T = 64, 48, 14


def conts(payload, n=2, key_every=5, window=4, **kw):
    """Lane containers of n streams (keyframes every 5, windows of 4 →
    keyframe-snapped windows of 4 and 1 frames)."""
    return [transcode_to_lane(make_avi(s, X, Y, T, key_every=key_every)[0],
                              window=window, K=2, payload=payload, **kw)
            for s in range(n)]


RAW, RANS = conts("raw"), conts("rans")


def compare(containers, **kw):
    """Both pipelines over the containers → the port's pipeline."""
    jp = J.VideoIngestPipeline([MemorySource(c) for c in containers],
                               J.IngestConfig(**kw))
    pp = P.VideoIngestPipeline([MemorySource(c) for c in containers],
                               P.IngestConfig(device="cpu", **kw))
    ref, port = list(jp), list(pp)
    assert ref
    assert_windows_equal(ref, port)
    return pp


@pytest.mark.parametrize("payload", ["raw", "rans"])
@pytest.mark.parametrize("kw", [
    dict(sp_device_path="lane"),
    dict(sp_device_path="lane", still_elision=True),
    dict(sp_device_path="lane", model_downscale=2),
    dict(sp_device_path="lane", still_elision=True, model_downscale=2,
         emit_frames=False),
    dict(sp_device_path="lane", emit_model_input=False),
    dict(sp_device_path="lane", model_downscale=2, model_packed=True),
    dict(),  # auto-detected: every source is a lane container
], ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()) or "auto")
def test_lane_windows(payload, kw):
    """Ragged windows (lengths 4 and 1, pow2 Tpad buckets), the all-stills
    window (the 1-frame windows are stills), dense and still-elided, with
    and without ds2 model tensors; the flag or auto-detection."""
    compare(RAW if payload == "raw" else RANS, **kw)


@pytest.mark.parametrize("payload", ["raw", "rans"])
@pytest.mark.parametrize("frame_range", [(7, 11), (0, 3), (6, 40)])
def test_lane_frame_range(payload, frame_range):
    """frame_range starts at the latest restart window <= t0 and stops once
    t1 is covered (prefix-sum bases over ragged windows)."""
    compare(RAW if payload == "raw" else RANS, sp_device_path="lane",
            frame_range=frame_range)


def test_lane_one_keyframe_chains_windows():
    """One keyframe: every window after the first chains on the carry (not
    a restart), dense and elided, rans init plane only on window 0."""
    cs = conts("rans", n=3, key_every=0)
    compare(cs, sp_device_path="lane")
    compare(cs, sp_device_path="lane", still_elision=True, model_downscale=2)


def test_lane_ragged_batch():
    """Streams of different lengths (stride-aligned windows): a stream
    without window wi passes its carry through."""
    cs = [transcode_to_lane(make_avi(s, X, Y, n, key_every=4)[0], window=4,
                            K=2, align="stride")
          for s, n in ((0, 12), (1, 8))]
    compare(cs, sp_device_path="lane")
    compare(cs, sp_device_path="lane", still_elision=True)


def sp16_avi(seed):
    """A 16 bpp SP stream (5-bit channels): the model epilogue's bpp16."""
    rng = np.random.default_rng(seed)
    enc = ScreenPressorEncoder(4, X, Y, bpp=16)
    f = (rng.integers(0, 32, (Y, X), dtype=np.uint32)
         | (rng.integers(0, 32, (Y, X), dtype=np.uint32) << 8)
         | (rng.integers(0, 32, (Y, X), dtype=np.uint32) << 16))
    chunks = []
    for t in range(6):
        if t:
            f = f.copy()
            f[2:2 + t, 3:9] = 0x0A0B0C
        flat = f.reshape(-1).copy()
        chunks.append(enc.encode_i(flat) if t == 0 else enc.encode_p(flat))
    return mux_avi(chunks, X, Y, 16, codec="SPV4",
                   keyflags=[t == 0 for t in range(6)])


@pytest.mark.parametrize("payload", ["raw", "rans"])
def test_lane_16bpp(payload):
    cs = [transcode_to_lane(sp16_avi(s), window=3, K=2, payload=payload)
          for s in (1, 2)]
    pp = compare(cs, sp_device_path="lane", model_downscale=2)
    assert pp._bpp16


def test_lane_audio_passthrough():
    """The containers' MP3 stream rebuilds the same AudioTrack sections as
    the reference's (and None without audio)."""
    from jsplayer_tpu.encode.mp3_synth import make_silence_frames
    from test_torch_host_copies import plain

    streams, _, keys = make_stream(6, X, Y, 6)
    mp3, _, _ = make_silence_frames(20)
    avi = mux_avi(streams, X, Y, 24, codec="SPV4", keyflags=keys,
                  sound_chunks=[(0, mp3[: len(mp3) // 2]),
                                (3, mp3[len(mp3) // 2:])])
    cs = [transcode_to_lane(avi, window=4, K=2), RAW[0]]
    jp = J.VideoIngestPipeline([MemorySource(c) for c in cs],
                               J.IngestConfig(sp_device_path="lane"))
    pp = P.VideoIngestPipeline([MemorySource(c) for c in cs],
                               P.IngestConfig(device="cpu"))
    assert pp.audio_tracks[0] is not None and pp.audio_tracks[1] is None
    assert len(pp.audio_tracks[0].sections) > 0
    assert plain(pp.audio_tracks) == plain(jp.audio_tracks)
    assert pp.info.nframes == jp.info.nframes and pp.info.fps == jp.info.fps


def test_lane_errors_match_reference():
    """A mixed lane/AVI batch, streaming=True, an AVI under the lane flag
    and mismatched window boundaries raise ValueError as the reference
    does; a mesh raises NotImplementedError (not ported yet)."""
    avi = make_avi(0, X, Y, T)[0]
    for pkg, extra in ((J, {}), (P, {"device": "cpu"})):
        with pytest.raises(ValueError, match="mixes lane containers"):
            pkg.VideoIngestPipeline([MemorySource(RAW[0]),
                                     MemorySource(avi)],
                                    pkg.IngestConfig(**extra))
        with pytest.raises(ValueError, match="streaming"):
            pkg.VideoIngestPipeline([MemorySource(RAW[0])],
                                    pkg.IngestConfig(streaming=True,
                                                     **extra))
        with pytest.raises(ValueError, match="lane-container sources"):
            pkg.VideoIngestPipeline([MemorySource(avi)],
                                    pkg.IngestConfig(sp_device_path="lane",
                                                     **extra))
        odd = transcode_to_lane(make_avi(1, X, Y, T, key_every=3)[0],
                                window=4, K=2)
        pipe = pkg.VideoIngestPipeline(
            [MemorySource(RAW[0]), MemorySource(odd)],
            pkg.IngestConfig(sp_device_path="lane", **extra))
        with pytest.raises(ValueError, match="mismatched window boundaries"):
            list(pipe)
    with pytest.raises(TypeError, match="pipeline.mesh.Mesh"):
        P.VideoIngestPipeline([MemorySource(RAW[0])],
                              P.IngestConfig(device="cpu", mesh=object()))

"""The port's streaming ingest (IngestConfig(streaming=True), device="cpu")
holds host residency to O(window) as the reference's does
(tests/test_streaming_ingest.py): the same long stream, read in small
chunks, through both pipelines."""

import numpy as np
import torch

from jsplayer_tpu.encode.avi_mux import mux_avi
from jsplayer_tpu.encode.sp_enc import ScreenPressorEncoder, pack_rgb
from jsplayer_tpu.pipeline import ingest as J
from jsplayer_tpu_torch.pipeline import ingest as P
from test_streaming_ingest import X, Y, SmallChunkSource

torch.set_num_threads(1)


def noisy_sp_avi(nframes=192):
    """tests/test_streaming_ingest.py's residency stream: noisy 8x8 tiles,
    so each frame carries real compressed mass; a keyframe every 16."""
    rng = np.random.default_rng(7)
    enc = ScreenPressorEncoder(4, X, Y)
    f = np.full((Y, X), pack_rgb(7, 5, 9), dtype=np.uint32)
    streams = []
    for t in range(nframes):
        f = f.copy()
        y0, x0 = int(rng.integers(0, Y - 8)), int(rng.integers(0, X - 8))
        f[y0:y0 + 8, x0:x0 + 8] = rng.integers(0, 1 << 24, (8, 8))
        flat = f.reshape(-1)
        streams.append(enc.encode_i(flat) if t % 16 == 0
                       else enc.encode_p(flat))
    return mux_avi(streams, X, Y, 24, codec="SPV4",
                   keyflags=[t % 16 == 0 for t in range(nframes)])


def test_streaming_residency_stays_bounded():
    """The twin of the reference's test: the peak of resident_bytes over
    the windows stays under a quarter of the AVI, and the early frame slots
    are nulled (eviction ran)."""
    avi = noisy_sp_avi()
    pipe = P.VideoIngestPipeline(
        [SmallChunkSource(avi)],
        P.IngestConfig(window=8, streaming=True, device="cpu"))
    peak, n_windows = 0, 0
    for _ in pipe:
        peak = max(peak, pipe.readers[0].resident_bytes())
        n_windows += 1
    assert n_windows == 24
    assert peak < len(avi) / 4, (peak, len(avi))
    ld = pipe.readers[0].loader
    assert all(f is None or f.data is None for f in ld.frames[:160])


def test_resident_bytes_equals_the_reference_after_every_window():
    """The port's and the reference's readers hold the same compressed
    bytes after every window of the same stream."""
    avi = noisy_sp_avi(96)
    ref = J.VideoIngestPipeline([SmallChunkSource(avi)],
                                J.IngestConfig(window=8, streaming=True))
    port = P.VideoIngestPipeline(
        [SmallChunkSource(avi)],
        P.IngestConfig(window=8, streaming=True, device="cpu"))
    got, want = [], []
    for _, _ in zip(ref, port):
        want.append(ref.readers[0].resident_bytes())
        got.append(port.readers[0].resident_bytes())
    assert len(got) == 12 and min(got) > 0
    assert got == want

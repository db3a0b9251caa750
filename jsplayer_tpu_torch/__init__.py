"""jsplayer_tpu_torch — the PyTorch/CUDA port of jsplayer_tpu.

It imports torch and never jax, and nothing of jsplayer_tpu.  The host
stage (AVI demux in core/ and av/, MP3 → PCM through the system codec
library in av/pcm.py and native/ffshim, the ScreenPressor and MSVideo1
codecs, the lane container format in codecs/lane_format.py and its
transcoder transcode.py, the encoders, keyframe-window snapping in
pipeline/gop.py, the playback Manager and its checkpoint, the Player and
its web server) is a copy of jsplayer_tpu's modules at the same relative
paths, each pinned against its original by
tests/test_torch_host_copies.py.  The native host decoder
(native/spdec.cpp) and the FFmpeg shim (native/ffshim.cpp) are built with
g++ at first use into build/ at the repository root.  The device stage is
re-written here, with hand-written CUDA kernels for Hopper (csrc/, built
with nvcc into build/) beside plain torch twins that run on the CPU.

Public surface (the JAX package's names):
  Player / PlayerConfig          — interactive playback API (host only)
  VideoIngestPipeline / IngestConfig
                                 — batched AVI → model-tensor windows on a
                                   torch device (ScreenPressor kmv, bc,
                                   kmv_sparse, general and pallas paths;
                                   MSVideo1; lane containers)
  transcode_sp                   — re-encode SP streams between versions
  transcode_to_lane              — re-encode into the lane container
                                   (ingest's lane path)
  open_source                    — byte-range sources (file / memory)
"""

__version__ = "0.2.0"

from .core.source import ByteSource, FileSource, MemorySource, open_source  # noqa: F401
from .core.types import CodecType, VideoInfo  # noqa: F401


def __getattr__(name):  # lazy: keep `import jsplayer_tpu_torch` light
    if name in ("Player", "PlayerConfig"):
        from . import player

        return getattr(player, name)
    if name in ("VideoIngestPipeline", "IngestConfig"):
        from .pipeline import ingest

        return getattr(ingest, name)
    if name in ("transcode_sp", "transcode_to_lane"):
        from . import transcode

        return getattr(transcode, name)
    raise AttributeError(name)

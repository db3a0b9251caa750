"""jsplayer_tpu_torch — the PyTorch/CUDA port of jsplayer_tpu.

It imports torch and never jax, and nothing of jsplayer_tpu.  The host
stage (AVI demux in core/ and av/, the ScreenPressor and MSVideo1 codecs,
the lane container format in codecs/lane_format.py and its transcoder
transcode.py, the encoders, keyframe-window snapping in pipeline/gop.py)
is a copy of jsplayer_tpu's modules at the same relative paths, each
pinned against its original by tests/test_torch_host_copies.py.  The native host decoder (native/spdec.cpp)
is built with g++ at first use into build/libjsptpu_host.so at the
repository root.  The device stage is re-written here, with hand-written
CUDA kernels for Hopper (csrc/, built with nvcc into build/) beside plain
torch twins that run on the CPU.

Public surface:
  VideoIngestPipeline / IngestConfig — batched AVI → model-tensor windows
                                       (ScreenPressor kmv, bc, general
                                       and pallas paths; lane containers)
  transcode_to_lane                  — re-encode an AVI into the lane
                                       container (ingest's lane path)
  open_source / MemorySource         — byte-range sources
"""

from .core.source import MemorySource, open_source  # noqa: F401


def __getattr__(name):  # lazy: keep `import jsplayer_tpu_torch` light
    if name in ("VideoIngestPipeline", "IngestConfig"):
        from .pipeline import ingest

        return getattr(ingest, name)
    if name == "transcode_to_lane":
        from . import transcode

        return transcode.transcode_to_lane
    raise AttributeError(name)

"""jsplayer_tpu_torch — the PyTorch/CUDA port of jsplayer_tpu.

It imports torch and never jax.  The host stage (AVI demux, the native
ScreenPressor decoder, codecs, encoders) is shared with jsplayer_tpu as it
stands; the device stage is re-written here, with hand-written CUDA
kernels for Hopper (csrc/) beside plain torch twins that run on the CPU.

Public surface:
  VideoIngestPipeline / IngestConfig — batched AVI → model-tensor windows
                                       (ScreenPressor kmv path)
  open_source / MemorySource         — byte-range sources (shared)
"""

from jsplayer_tpu.core.source import MemorySource, open_source  # noqa: F401


def __getattr__(name):  # lazy: keep `import jsplayer_tpu_torch` light
    if name in ("VideoIngestPipeline", "IngestConfig"):
        from .pipeline import ingest

        return getattr(ingest, name)
    raise AttributeError(name)

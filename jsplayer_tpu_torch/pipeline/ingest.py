"""Batched video ingestion on torch: AVI sources → model-input tensors.

Counterpart of jsplayer_tpu/pipeline/ingest.py.  N AVI streams are
demuxed on the host and entropy-decoded (the native C++ decoder, or the
pure-Python oracle where the native library is missing), then
reconstructed on the device in windows.  Failures
quarantine per stream; decoded pixels never round-trip to the host between
windows.

  * ``sp_device_path="kmv"`` (the main path): the host emits the kmv
    transport; the device scan may elide stills (CONCAT and PADDED layouts)
    and fuse the model epilogue.
  * ``"bc"``: the host emits the bc transport (per-block codes and rects,
    and a plane that holds only data-rect pixels); the device scan,
    csrc/bc_compose.cu, may elide stills (CONCAT and PADDED layouts) and
    fuse the model epilogue.
  * ``"general"`` and ``"pallas"``: the host captures each frame's block
    commands (bts/mv/rect) and decoded frame (payload); the device runs the
    block-command scan, csrc/sp_motion.cu in its general or fused mode.
    As in the reference, these paths ignore still_elision and emit_frames.
  * ``"kmv_sparse"``: the host ships per-block motion codes, K vectors and
    final-content 16x16 tiles (the native decoder's emission, ragged: one
    flat tile array a window, or the oracle's capture through
    prepare_kmv_sparse), optionally rANS-coded (``sparse_lane_payload``:
    kernels/lane_transport, decoded by csrc/rans_lanes.cu); window-leading
    keyframes of every stream ride as the scan's init.  The device scan is
    csrc/kmv_sparse.cu.  As in the reference, it ignores still_elision
    (beyond keyframe-snapped window starts) and emit_frames.
  * ``"lane"``: lane containers (codecs/lane_format, made by
    transcode.transcode_to_lane), found by their magic without the flag
    too.  The host only slices the parsed windows into shared buckets; the
    device builds each window's unique rows (raw payload bytes, or the rANS
    decode of csrc/rans_lanes.cu) and scans with csrc/bc_compose.cu's lane
    instance (kernels/lane_recon), still-elided or dense.
  * MSVideo1 AVIs (16-bit, and 8-bit palettized), found by their codec: the
    host parses each frame into per-block commands (native or
    codecs/msvideo1.parse_commands) and one launch of csrc/msv1_paint.cu
    paints the window (kernels/msv1_paint); no elision, as in the
    reference.  Each 8-bit stream is parsed with its own header's palette,
    which repairs reference host fault 4 (ROADMAP.md §3): the reference
    parses every stream of the batch with stream 0's.

The window dicts have the reference's keys, shapes and meaning.  u32
planes (``frames_u32``) are int32 tensors holding the u32 bits (see
device.py); ``outmap`` stays a numpy array as in the reference.

A mesh (pipeline/mesh.Mesh, the reference's multi-device sharding)
shards the streams over its dp axis on the kmv, bc, lane and MSV1 paths
(the sharded steps of pipeline/batch.py and
kernels/lane_recon.make_lane_decode_step, the ported kernels on every
slot); with a gop axis larger than 1, G keyframe-led windows of each
stream decode in one [B, G, T] dispatch (kmv and bc with the native host
stage, and the lane path's restart windows).  As in the reference,
kmv_sparse, general and pallas decode unsharded under a mesh.  The oracle
branch of kmv_sparse repairs reference host fault 3 (ROADMAP.md §3): a
stream quarantined mid-window keeps the frames it decoded before the
failure.

StreamReader, _StreamingFrames, _trim_window, _oracle_decode_step, the
host-buffer pool and _pow2ceil are copies of the reference's: its module
imports jax at the top, which this package never does.  StreamReader adds
the tracer's jsp.audio span around the MP3 parsing it drives (the up-front
drain, and each parse of the streaming pump, which runs in a jsp.demux
span) and its counters audio.frames, audio.bytes and audio.sections.
"""

from __future__ import annotations

import itertools
import sys
from dataclasses import dataclass, replace
from typing import Callable, Iterator, Optional, Sequence

import numpy as np
import torch

from ..core.loader import DataLoaderAVISeq
from ..core.source import ByteSource
from ..core.types import CodecType, VideoInfo
from ..device import (is_pinned, pin_host, resolve_device, to_device,
                      to_device_into, torch_to_u32, upload_guard)
from ..codecs.msvideo1 import palette_to_u32, parse_commands
from ..kernels import msv1_paint, sp_recon
from ..kernels.rgb_convert import ds2_packed_output, to_model_input
from ..kernels.sp_motion_pallas import decode_batch_fused
from ..utils.logging import LOG, TRACE
from .batch import (DecodeConfig, make_sp_decode_step_bc,
                    make_sp_decode_step_kmv)
from .mesh import SlotBuilt

#: the sp_device_path values (the reference's); another raises ValueError
PORTED_SP_PATHS = ("kmv", "bc", "kmv_sparse", "general", "pallas", "lane")

# Process-wide host-buffer pool: window buffers are hundreds of MB and fresh
# pages fault in slowly, so a new pipeline re-allocating them costs more
# than the decode itself.  Buffers are checked out exclusively (popped)
# while a pipeline iterates and returned when its iterator finishes.  A
# pooled kmv plane travels with its `dirty` incremental-fill state under
# one key: the native fill trusts `dirty` to say what the plane holds.  A
# plane pooled for a CUDA pipeline is page-locked (its key says so), and
# travels with `guard`, the events of the uploads still reading it.
_BUFFER_POOL: dict = {}

# pipeline serials: a window's trace id is (serial, start frame)
_SERIALS = itertools.count()


def _pool_acquire(key, builder):
    buf = _BUFFER_POOL.pop(key, None)
    return buf if buf is not None else builder()


def _pool_release(key, buf):
    if buf is not None:
        _BUFFER_POOL[key] = buf


def carry_from_numpy(frames: np.ndarray, device) -> torch.Tensor:
    """Per-stream carry frames [B, Y, X] u32 (e.g. a reference pipeline's
    ``np.asarray(pipe._carry)``) → the port's device carry."""
    return to_device(np.array(frames, dtype=np.uint32), device)


def carry_to_numpy(carry: torch.Tensor) -> np.ndarray:
    """The port's device carry → [B, Y, X] u32 on the host."""
    return torch_to_u32(carry)


# byte of a u32 word that holds bits 24-31 (the kmv word's ptype and slot)
_TOP_BYTE = 3 if sys.byteorder == "little" else 0


def _full_frame(plane: np.ndarray) -> bool:
    """Whether a kmv paycode plane [Y, X] u32 overwrites the whole frame:
    every word's ptype (bits 24-25) is 1, read on a uint8 view of the
    words' top bytes."""
    top = plane.view(np.uint8)[..., _TOP_BYTE::4]
    return bool(((top & 3) == 1).all())


def upload_changed_rows(pc: np.ndarray, rows: np.ndarray,
                        counts: np.ndarray, device,
                        cpad: int | None = None) -> torch.Tensor:
    """Place each stream's changed paycode planes pc[b, rows[b, :counts[b]]]
    from the host window pc [B, T, Y, X] u32 into one device stack, one
    upload (device.to_device_into) a run of consecutive frames; no host
    copy of a plane is made.  cpad None: the CONCAT stack [sum(counts), Y,
    X], streams back to back; else the PADDED stack [B, cpad, Y, X], its
    pad rows [b, counts[b]:] zeroed on the device.  int32 bit views;
    counts elision.direct_rows and elision.direct_runs."""
    B, plane = pc.shape[0], pc.shape[2:]
    counts = np.asarray(counts, dtype=np.int64)
    if cpad is None:
        out = torch.empty((int(counts.sum()),) + plane, dtype=torch.int32,
                          device=device)
        flat, base = out, np.cumsum(counts) - counts
    else:
        out = torch.empty((B, cpad) + plane, dtype=torch.int32,
                          device=device)
        for b in range(B):
            if counts[b] < cpad:
                out[b, int(counts[b]):].zero_()
        flat, base = out.view((B * cpad,) + plane), np.arange(B) * cpad
    runs = 0
    for b in range(B):
        idx = rows[b, : counts[b]]
        if not len(idx):
            continue
        # run boundaries: where the next changed frame is not t + 1
        cuts = np.flatnonzero(np.diff(idx) != 1) + 1
        for s, e in zip([0, *cuts], [*cuts, len(idx)]):
            t0, o = int(idx[s]), int(base[b] + s)
            to_device_into(pc[b, t0:t0 + e - s], flat[o:o + e - s])
            runs += 1
    LOG.count("elision.direct_rows", int(counts.sum()))
    LOG.count("elision.direct_runs", runs)
    return out


def _gather_rows(a: np.ndarray, rows: np.ndarray,
                 valid: np.ndarray) -> np.ndarray:
    """a[b, rows[b]] of a [B, T, ...] array for every stream b: the rows
    of compact_changed_batch's plan, zero where `valid` is False."""
    out = a[np.arange(a.shape[0])[:, None], rows]
    out[~valid] = 0
    return out


def _padded_outmap(outmap: np.ndarray, cpad: int) -> np.ndarray:
    """The PADDED layout's outmap [E, T] (E entries of cpad rows each) →
    indices into the flat [E * cpad] row stack; -1 stays -1."""
    return np.where(
        outmap >= 0,
        outmap + (np.arange(outmap.shape[0], dtype=np.int32) * cpad)[:, None],
        -1).astype(np.int32)


@dataclass(frozen=True)
class _PlaneTransport:
    """What differs between the two plane transports, kmv and bc.  Both
    carry a u32 plane [B, T, Y, X], small per-frame arrays and `changed`,
    and every scan takes (init, plane, *small, changed)."""
    name: str  # the pool key of its host buffers
    small: tuple  # the small per-frame arrays' buffer keys, mvk last
    buffers: Callable  # (lead shape, Y, X, nb, K) → the host buffers
    # the native decode of one frame into the buffers at index i:
    # (dec, src, buf, i, K) → (changed, significant)
    decode: Callable
    # (plane, *small) of one frame → whether it overwrites the whole frame
    full_frame: Callable
    decode_batch: Callable  # the dense batch scan
    decode_compact: Callable  # one scan over a sequence of changed frames
    decode_model: Callable  # the batch scan fused into model tensors
    make_step: Callable  # pipeline/batch's sharded step
    # a single stream without a mesh takes the exact compact scan
    # (compact_changed) instead of the batched elision, as the reference's
    # kmv route does
    single_compact: bool

    def arrays(self, buf: dict) -> tuple:
        """A window's (plane, *small) in its host buffers."""
        return (buf["plane"],) + tuple(buf[k] for k in self.small)


_PLANE_TRANSPORTS = {
    # the paycode plane; dirty rows carry each pooled plane's
    # incremental-fill state across windows AND pipelines (they live with
    # it)
    "kmv": _PlaneTransport(
        name="kmv", small=("mvk",),
        buffers=lambda lead, Y, X, nb, K: dict(
            plane=np.zeros(lead + (Y, X), dtype=np.uint32),
            mvk=np.zeros(lead + (K, 2), dtype=np.int32),
            dirty=np.zeros(lead + (nb + 1,), dtype=np.int32)),
        decode=lambda dec, src, buf, i, K: dec.decompress_kmv(
            src, dec.is_key_frame(src), buf["plane"][i], buf["mvk"][i],
            K=K, dirty=buf["dirty"][i]),
        full_frame=lambda pc, mvk: _full_frame(pc),
        decode_batch=sp_recon.decode_batch_kmv,
        decode_compact=sp_recon.decode_sequence_kmv_compact,
        decode_model=sp_recon.decode_batch_kmv_model,
        make_step=make_sp_decode_step_kmv, single_compact=True),
    # a plane that holds only data-rect pixels, the block structure in
    # bcode/rloc; a frame overwrites the whole frame when every block has
    # code 1 and the rect (0, 0, 16, 16)
    "bc": _PlaneTransport(
        name="bc", small=("bcode", "rloc", "mvk"),
        buffers=lambda lead, Y, X, nb, K: dict(
            plane=np.zeros(lead + (Y, X), dtype=np.uint32),
            mvk=np.zeros(lead + (K, 2), dtype=np.int32),
            bcode=np.zeros(lead + (nb,), dtype=np.uint8),
            rloc=np.zeros(lead + (nb, 4), dtype=np.uint8)),
        decode=lambda dec, src, buf, i, K: dec.decompress_bc(
            src, dec.is_key_frame(src), buf["plane"][i], buf["mvk"][i],
            buf["bcode"][i], buf["rloc"][i], K=K),
        full_frame=lambda plane, bcode, rloc, mvk: (
            bool((bcode == 1).all())
            and bool((rloc == (0, 0, 16, 16)).all())),
        decode_batch=sp_recon.decode_batch_bc,
        decode_compact=sp_recon.decode_sequence_bc_compact,
        decode_model=sp_recon.decode_batch_bc_model,
        make_step=make_sp_decode_step_bc, single_compact=False),
}


def _trim_window(out: dict, n: int) -> dict:
    """Trim a window dict's per-timeline-slot arrays to its true length
    (keyframe-snapped windows are shorter than cfg.window; the chunk's
    no-change padding must not be emitted — the next window owns those
    timeline positions).  Flat elided stacks stay whole: the trimmed
    outmap governs which rows are read."""
    if out.get("significant") is not None:
        out["significant"] = out["significant"][:, :n]
    om = out.get("outmap")
    if om is not None:
        # [B, T] batched elision; [T] single-stream elision
        out["outmap"] = om[:, :n] if om.ndim == 2 else om[:n]
    else:  # dense emission: [B, T, ...] per-timeline arrays
        for k in ("frames_u32", "model_input"):
            if out.get(k) is not None and out[k].ndim >= 3:
                out[k] = out[k][:, :n]
    return out


def _pow2ceil(n: int) -> int:
    """Smallest power of two >= max(n, 1): the reference's bucketing unit
    (its jit keys), kept so the lane windows' shapes equal its own."""
    return 1 << max(int(n) - 1, 0).bit_length()


def _oracle_decode_step(dec, src: bytes, isk: bool, X: int, Y: int):
    """One pure-Python host-stage decode step: run the oracle with command
    capture → (significant, capture dict).  Raises like the oracle does on
    corrupt streams — call through VideoIngestPipeline._guard."""
    cap: dict = {}
    dec.capture = cap
    dst = np.zeros(X * Y, dtype=np.uint32)
    if isk:
        dec.decompress_i(src, dst)
        s = True
    else:
        res = dec.decompress_p(src, dst)
        s = bool(res.significant_changes)
    return s, cap


@dataclass
class IngestConfig:
    """The reference's IngestConfig (same fields, same defaults) plus
    `device`.  sp_device_path must be one of PORTED_SP_PATHS, and mesh None
    or a pipeline/mesh.Mesh (checked by VideoIngestPipeline)."""
    window: int = 16  # frames per emitted window (device scan length)
    emit_model_input: bool = True
    # False → kmv windows emit ONLY model tensors (fused into the decode
    # scan; the full-res frame stack is never written)
    emit_frames: bool = True
    model_dtype: str = "bfloat16"  # a torch dtype name
    model_downscale: int = 1  # power-of-two box downsample in the epilogue
    # downscale==2 only: emit the PACKED ds2 plane ([.., H/2, W/2] i32 of
    # r/g/b 10-bit field sums) instead of unpacked NHWC tensors; consumers
    # unpack with rgb_convert.unpack_ds2
    model_packed: bool = False
    insignificant_lines: int = 0
    # "kmv" (kmv transport), "bc" (block-command transport), "kmv_sparse"
    # (block codes + final-content tiles), "general" or "pallas" (captured
    # block commands; these three ignore still_elision and emit_frames),
    # "lane" (lane containers; chosen without the flag when every source is
    # one)
    sp_device_path: str = "kmv"
    kmv_k: int = 2
    # kmv_sparse only: rANS-code the tile payload on the host and decode it
    # on the device (kernels/lane_transport, packed layout)
    sparse_lane_payload: bool = False
    # True: unchanged frames never enter the device scan; the dict gains
    # "outmap" (see the reference's field comment for the layouts)
    still_elision: bool = False
    # Multi-device: a pipeline/mesh.Mesh shards the stream batch over its
    # dp axis (B divisible by the dp size) and, with a gop axis > 1,
    # groups keyframe-led windows over it; the pipeline's device is then
    # the first local slot's.  None = one device
    mesh: object = None
    # Long-stream mode: demux windows on demand and evict consumed bytes
    streaming: bool = False
    # Clip decode [t0, t1) from the nearest shared keyframe <= t0
    frame_range: Optional[tuple] = None
    # where the device stage runs; "cuda" raises when there is no card
    device: str = "cuda"

    def __post_init__(self):
        resolve_device(self.device)


def _audio_mark(mp) -> int:
    """The MP3 scanner's sound-buffer offset below which every frame has
    gone to the track: its first pending frame's start, or its position."""
    return mp.frames[0][0] if mp.frames else mp.position


def _parse_audio(loader, parse: Callable[[], None]) -> None:
    """Run `parse`, a stretch of the loader's MP3 parsing.  While the
    tracer records and the source has sent sound bytes, in a jsp.audio
    span, counting what it handed to the track: audio.frames (MP3 frames),
    audio.bytes (the sound bytes below the scanner's mark: those frames,
    and any bytes it skipped between them) and audio.sections (sections
    added to the AudioTrack)."""
    if not TRACE.active or not loader.sound_buffer.total_size:
        parse()
        return
    mp = loader.mp3_parser
    f0, b0, s0 = mp.frames_processed, _audio_mark(mp), len(mp.sections)
    with TRACE.span("jsp.audio"):
        parse()
    LOG.count("audio.frames", mp.frames_processed - f0)
    LOG.count("audio.bytes", _audio_mark(mp) - b0)
    LOG.count("audio.sections", len(mp.sections) - s0)


class StreamReader:
    """Demux one AVI source into frame bytes (host).

    Default mode demuxes the whole file up front.  ``streaming=True`` pumps
    the demuxer only as far as the pipeline's current window and EVICTS
    consumed compressed bytes, so residency stays O(window)."""

    def __init__(self, source: ByteSource, streaming: bool = False):
        self.loader = DataLoaderAVISeq()
        self.loader.open(source)
        self.streaming = streaming
        self.eof = False
        self._released = 0
        if streaming:
            # pump only until the header yields the geometry
            while self.loader.video_info is None:
                if not self.loader.pump():
                    self.eof = True
                    break
            if self.loader.video_info is None:
                raise ValueError(
                    "no video header found (file truncated before avih/strf?)")
            self.info: VideoInfo = self.loader.video_info
            self.frames = _StreamingFrames(self)
            self.audio_track = self.loader.audio_track
            return
        self.loader.pump_all()
        self.eof = True
        # drain the MP3 side once up front
        _parse_audio(self.loader, self._drain_sound)
        if self.loader.video_info is None:
            raise ValueError(
                "no video header found (file truncated before avih/strf?)")
        self.info: VideoInfo = self.loader.video_info
        self.frames: list[bytes] = [
            (f.data if f is not None and f.data is not None else b"")
            for f in self.loader.frames
        ]
        self.audio_track = self.loader.audio_track

    def _drain_sound(self) -> None:
        for _ in range(100000):
            before = self.loader.mp3_parser.frames_processed
            self.loader.parse_sound()
            if self.loader.mp3_parser.frames_processed == before:
                break
        self.loader.mp3_parser.on_data_end()
        self.loader.parse_sound()

    # -- streaming mode ------------------------------------------------------

    def fetch_upto(self, hi: int) -> None:
        """Pump the demuxer until frame `hi` (exclusive) is parsed or EOF;
        the MP3 scanner rides along.  Progress is the PARSE watermark."""
        ld = self.loader
        with TRACE.span("jsp.demux"):
            while not self.eof and ld.loaded_frames_end() < hi:
                if not ld.pump():
                    self.eof = True
                _parse_audio(ld, ld.parse_sound)
            if self.eof and not ld.mp3_parser.parsing_complete:
                _parse_audio(ld, ld.parse_sound)

    def available(self) -> int:
        return self.loader.loaded_frames_end()

    def window_bytes(self, lo: int, hi: int) -> list[bytes]:
        self.fetch_upto(hi)
        assert lo >= self._released, "window re-read after eviction"
        out = []
        for i in range(lo, hi):
            f = (self.loader.frames[i]
                 if i < len(self.loader.frames) else None)
            out.append(f.data if f is not None and f.data is not None
                       else b"")
        return out

    def release_upto(self, lo: int) -> None:
        """Evict everything below frame `lo`: null the frame slots and drop
        chunk-buffer bytes below the demuxer's / MP3 scanner's read floors."""
        ld = self.loader
        for i in range(self._released, min(lo, len(ld.frames))):
            if ld.frames[i] is not None:
                ld.frames[i].data = None
        self._released = max(self._released, lo)
        if ld.demuxer is not None:
            ld.buffer.drop_before(ld.demuxer._pos)
        mp = ld.mp3_parser
        floor = mp.position
        for lst in (mp.frames, mp.long_frames):
            if lst:
                floor = min(floor, lst[0][0])
        ld.sound_buffer.drop_before(floor)

    def resident_bytes(self) -> int:
        """Compressed bytes currently held (observability for the window)."""
        ld = self.loader
        frames_b = sum(
            len(f.data) for f in ld.frames
            if f is not None and f.data is not None)
        return (ld.buffer.bytes_available(getattr(ld.buffer, "_base", 0))
                + ld.sound_buffer.bytes_available(
                    getattr(ld.sound_buffer, "_base", 0)) + frames_b)


class _StreamingFrames:
    """Minimal sequence facade over a streaming reader (len = frames parsed
    so far) — keeps non-streaming call sites (`len(r.frames)`) working."""

    def __init__(self, reader: StreamReader):
        self._r = reader

    def __len__(self) -> int:
        return self._r.loader.loaded_frames_end()


class VideoIngestPipeline:
    """Iterate model-tensor windows over a batch of same-geometry
    ScreenPressor streams or lane containers."""

    def __init__(self, sources: Sequence[ByteSource],
                 config: Optional[IngestConfig] = None):
        TRACE.poll()
        self._serial = next(_SERIALS)
        self.cfg = config or IngestConfig()
        # real (timeline) frames of each stream in the window being
        # decoded, for the counters; __iter__ sets it a window
        self._n_real = self.cfg.window
        self.device = resolve_device(self.cfg.device)
        # auto-detect lane-container sources (4-byte magic) so ingest works
        # on .jlv files without an explicit sp_device_path="lane"
        if self.cfg.sp_device_path != "lane" and sources:
            from ..codecs import lane_format

            try:
                heads = [lane_format.is_lane_container(s.read_range(0, 4))
                         for s in sources]
            except Exception:
                heads = [False]
            if all(heads):
                self.cfg = replace(self.cfg, sp_device_path="lane")
            elif any(heads):
                raise ValueError(
                    "batch mixes lane containers and AVIs — transcode or "
                    "split the batch")
        if self.cfg.sp_device_path not in PORTED_SP_PATHS:
            raise ValueError(
                f"unknown sp_device_path={self.cfg.sp_device_path!r}; one "
                f"of {PORTED_SP_PATHS}")
        if self.cfg.mesh is not None:
            from .mesh import Mesh

            if not isinstance(self.cfg.mesh, Mesh):
                raise TypeError(
                    f"mesh must be a jsplayer_tpu_torch.pipeline.mesh.Mesh "
                    f"(make_mesh), got {type(self.cfg.mesh).__name__}")
            if self.cfg.mesh.device.type != self.device.type:
                raise ValueError(
                    f"device {self.cfg.device!r} does not match the mesh's "
                    f"{self.cfg.mesh.device}")
            self.device = self.cfg.mesh.device
        self._model_dtype = getattr(torch, self.cfg.model_dtype)
        self._carry: Optional[torch.Tensor] = None
        # pooled host buffers checked out by this pipeline, by pool key
        self._bufs: dict = {}
        if self.cfg.sp_device_path == "lane":
            with TRACE.span("jsp.demux"):
                self._init_lane(sources)
            return
        with TRACE.span("jsp.demux"):
            self.readers = [StreamReader(s, streaming=self.cfg.streaming)
                            for s in sources]
        info0 = self.readers[0].info
        for r in self.readers:
            assert (r.info.width, r.info.height, r.info.codec) == (
                info0.width, info0.height, info0.codec
            ), "streams in a batch must share geometry and codec"
        self.info = info0
        # streaming mode: a lower bound that grows as windows demux
        self.nframes = max(len(r.frames) for r in self.readers)
        # 16bpp ScreenPressor decodes to 5-bit channels (scaled <<3 for
        # the model, Manager.hx:363-370); MSV1 16-bit already resolves to
        # 8-bit channels at parse
        self._bpp16 = (info0.bpp == 16
                       and info0.codec == CodecType.SCREENPRESSOR)
        #: per-stream AudioTrack (MP3 sections, PTS, time_loaded watermark)
        self.audio_tracks = [r.audio_track for r in self.readers]
        # each stream's palette as u32 colours, from its own header (None
        # for 16-bit MSV1).  Reference host fault 4, repaired: the
        # reference parses every stream of an 8-bit batch with stream 0's
        self._pals = [palette_to_u32(r.info.palette)
                      if r.info.codec == CodecType.MSVC8 else None
                      for r in self.readers]
        self._pcm_cache = None
        # per-stream failure quarantine: a malformed frame freezes that
        # stream at its last good frame; other batch slots continue
        self.quarantined: set[int] = set()
        self.quarantine_errors: list[tuple[int, str]] = []
        #: which elision layout each window used (CONCAT keyframe-led,
        #: PADDED mid-GOP)
        self.stats = {"concat_windows": 0, "padded_windows": 0}

    def _window_starts(self) -> list[int]:
        if self.cfg.frame_range is not None:
            assert not self.cfg.streaming, \
                "frame_range needs random access (streaming=False)"
            t0, t1 = self.cfg.frame_range
            t0 = max(0, min(int(t0), self.nframes))
            t1 = max(t0, min(int(t1), self.nframes))
            k0 = self._range_keyframe(t0)
            return list(range(k0, t1, self.cfg.window))
        starts = list(range(0, self.nframes, self.cfg.window))
        if (self.cfg.still_elision and not self.cfg.streaming
                and self._gop_group == 1
                and self.info.codec == CodecType.SCREENPRESSOR):
            # keyframe-aligned scheduling: a window that starts mid-GOP
            # falls off the CONCAT elision layout onto the padded scans, so
            # snap each boundary DOWN to the latest keyframe within reach;
            # chunks pad with no-change frames and emissions are trimmed
            keys = self._keyframe_positions()
            if len(keys) > 1:
                from .gop import snap_window_starts

                starts = snap_window_starts(keys, self.nframes,
                                            self.cfg.window)
        return starts

    def _keyframe_prober(self):
        """A decoder of the batch's codec, for its is_key_frame."""
        vi = self.info
        if vi.codec == CodecType.SCREENPRESSOR:
            from ..codecs.screenpressor import ScreenPressor

            return ScreenPressor(vi.width, vi.height, vi.bpp)
        from ..codecs.msvideo1 import MSVideo1_8bit, MSVideo1_16bit

        if vi.codec == CodecType.MSVC8:
            return MSVideo1_8bit(vi.width, vi.height, vi.palette or b"")
        return MSVideo1_16bit(vi.width, vi.height)

    def _keyframe_positions(self) -> list[int]:
        """Keyframe indices shared by EVERY stream in the batch (probed
        from frame bytes)."""
        with TRACE.span("jsp.demux"):
            prober = self._keyframe_prober()
            keys = None
            for r in self.readers:
                ks = {t for t, f in enumerate(r.frames)
                      if f and prober.is_key_frame(f)}
                keys = ks if keys is None else (keys & ks)
            return sorted(keys or ())

    def _range_keyframe(self, t0: int) -> int:
        """Nearest common keyframe ≤ t0 across the batch (the seek reset
        point), probed from the frame bytes."""
        prober = self._keyframe_prober()

        def nearest(frames, n):
            n = min(n, len(frames) - 1)
            while n > 0 and not (frames[n]
                                 and prober.is_key_frame(frames[n])):
                n -= 1
            return n

        k0 = nearest(self.readers[0].frames, t0)
        for b, r in enumerate(self.readers[1:], 1):
            kb = nearest(r.frames, t0)
            assert kb == k0, (
                f"frame_range needs a shared keyframe at the window start: "
                f"stream 0 rewinds to {k0}, stream {b} to {kb} — align the "
                f"batch's keyframe cadence or decode streams separately")
        return k0

    def __iter__(self) -> Iterator[dict]:
        """Host→device overlap: window t's kernels are enqueued (CUDA
        launches return at once), then the host stage of window t+1 runs
        while the card works; window t is yielded after that.  The carry
        stays on the device."""
        if self.cfg.sp_device_path == "lane":
            yield from self._iter_lane()
            return
        W = self.cfg.window
        pending = None
        try:
            if self.cfg.streaming:
                start = 0
                while True:
                    chunk = []
                    got_any = False
                    for r in self.readers:
                        frames = r.window_bytes(start, start + W)
                        got_any |= any(len(f) > 0 for f in frames) or \
                            r.available() > start
                        chunk.append(frames)
                    if not got_any:
                        break
                    TRACE.poll()
                    with TRACE.span("jsp.window", (self._serial, start)):
                        self._n_real = max(0, min(W, max(
                            r.available() for r in self.readers) - start))
                        out = self._decode_window(chunk, start)
                        for r in self.readers:
                            r.release_upto(start + W)  # O(window) residency
                        self.nframes = max(
                            self.nframes,
                            *(r.available() for r in self.readers))
                        LOG.count("frames.timeline",
                                  len(self.readers) * self._n_real)
                    if pending is not None:
                        yield pending
                    pending = out
                    start += W
                if pending is not None:
                    yield pending
                return
            G = self._gop_group
            from .. import native as _nat
            if (G > 1 and self.info.codec == CodecType.SCREENPRESSOR
                    and self.cfg.sp_device_path in _PLANE_TRANSPORTS
                    and _nat.available()):
                # gop-axis grouping: G keyframe-led windows a sharded
                # [B, G, T] dispatch
                starts_all = self._window_starts()
                for i in range(0, len(starts_all), G):
                    grp = starts_all[i: i + G]
                    chunks = []
                    for st in grp:
                        chunk = []
                        for r in self.readers:
                            frames = r.frames[st: st + W]
                            frames += [b""] * (W - len(frames))
                            chunk.append(frames)
                        chunks.append(chunk)
                    while len(chunks) < G:  # stream-end padding (discarded)
                        chunks.append([[b""] * W for _ in self.readers])
                    TRACE.poll()
                    with TRACE.span("jsp.window", (self._serial, grp[0])):
                        outs = self._decode_sp_window_group(chunks, grp)
                    yield from outs
                return
            starts = self._window_starts()
            for i, start in enumerate(starts):
                # keyframe-aligned windows may be shorter than W: decode
                # [start, end), pad the chunk to W with no-change frames,
                # trim the emission
                TRACE.poll()
                with TRACE.span("jsp.window", (self._serial, start)):
                    end = (starts[i + 1] if i + 1 < len(starts)
                           else start + W)
                    chunk = []
                    for r in self.readers:
                        frames = r.frames[start:end]
                        frames += [b""] * (W - len(frames))  # no change
                        chunk.append(frames)
                    self._n_real = max(0, min(end, self.nframes) - start)
                    out = self._decode_window(chunk, start)
                    if end - start < W:
                        out = _trim_window(out, end - start)
                    LOG.count("frames.timeline",
                              len(self.readers) * self._n_real)
                if pending is not None:
                    yield pending
                pending = out
            if pending is not None:
                yield pending
        finally:
            self._release_buffers()

    def _decode_window(self, chunk, start) -> dict:
        if self.info.codec == CodecType.SCREENPRESSOR:
            return self._decode_sp_window(chunk, start)
        return self._decode_msv1_window(chunk, start)

    def _buffers(self, key: tuple, build) -> dict:
        """The pooled host buffers under `key` (with the batch's shape),
        checked out by this pipeline until its iterator finishes."""
        key = key + self._buf_key
        if key not in self._bufs:
            self._bufs[key] = _pool_acquire(key, build)
        return self._bufs[key]

    def _release_buffers(self):
        # a plane goes back with its pending guard: the non-blocking copies
        # of the last window may still read it, and the next pipeline to
        # take it waits for them before its first fill (_plane_buffers)
        for key, buf in self._bufs.items():
            _pool_release(key, buf)
        self._bufs = {}

    @property
    def _buf_key(self):
        vi = self.info
        return (len(self.readers), self.cfg.window, vi.height, vi.width,
                self.cfg.kmv_k)

    def _guard(self, b: int, fn, *args, default=None):
        """Run a per-frame decode step; on a malformed stream quarantine
        slot b (frozen at the last good frame) instead of failing the
        batch."""
        if b in self.quarantined:
            return default
        try:
            return fn(*args)
        except (ValueError, AssertionError, IndexError) as e:
            # the native decoder raises ValueError; the pure-Python oracle
            # can also raise AssertionError/IndexError on corrupt data
            self.quarantined.add(b)
            self.quarantine_errors.append((b, repr(e)))
            return default

    # -- ScreenPressor ---------------------------------------------------------

    def _sp_decoders(self):
        """Persistent per-stream host decoders: SP entropy/context state
        spans windows, so window boundaries must not reset the host stage."""
        if getattr(self, "_spdecs", None) is None:
            vi = self.info
            from .. import native as _native

            self._spdecs = []
            self._sp_native = _native.available()
            for _ in self.readers:
                if self._sp_native:
                    d = _native.NativeScreenPressor(vi.width, vi.height, vi.bpp)
                else:
                    from ..codecs.screenpressor import ScreenPressor

                    d = ScreenPressor(vi.width, vi.height, vi.bpp)
                d.preinit(self.cfg.insignificant_lines)
                self._spdecs.append(d)
        return self._spdecs

    def _decode_sp_window(self, chunk, start) -> dict:
        vi = self.info
        X, Y = vi.width, vi.height
        B, T = len(chunk), self.cfg.window
        nb = ((X + 15) // 16) * ((Y + 15) // 16)
        K = self.cfg.kmv_k
        decs = self._sp_decoders()
        if self.cfg.sp_device_path == "kmv_sparse":
            if self._sp_native:
                return self._decode_sp_window_sparse_native(chunk, start,
                                                            decs)
            return self._decode_sp_window_sparse(chunk, start, decs)
        tr = _PLANE_TRANSPORTS.get(self.cfg.sp_device_path)
        if tr is not None and self._sp_native:
            # the native decoder emits the transport during decode
            buf = self._plane_buffers(tr, (B, T))
            changed = np.zeros((B, T), dtype=bool)
            sig = np.zeros((B, T), dtype=bool)
            with TRACE.span("jsp.entropy"):
                self._decode_planes(tr, buf, chunk, changed, sig)
            return self._plane_route(tr, tr.arrays(buf), changed, sig, start,
                                     buf["guard"])
        if self.cfg.sp_device_path == "bc":
            return self._decode_sp_window_bc(chunk, start, decs)
        # command capture (bts/mv/rect + the decoded frame as payload) by
        # the native decoder or the pure-Python oracle; window buffers are
        # reused across iterations
        buf = self._sp_buffers(B, T, Y, X, nb)
        bts, mv, rect, payload = buf["bts"], buf["mv"], buf["rect"], buf["payload"]
        changed = np.zeros((B, T), dtype=bool)
        sig = np.zeros((B, T), dtype=bool)
        with TRACE.span("jsp.entropy"):
            for b, frames in enumerate(chunk):
                dec = decs[b]
                for t, src in enumerate(frames):
                    if self._sp_native:
                        isk = dec.is_key_frame(src)
                        got = self._guard(b, lambda: dec.decompress(
                            src, isk, capture=True, copy=False))
                        # quarantined: frozen at the last good frame
                        if got is None:
                            continue
                        view, _sig, cap = got
                        sig[b, t] = bool(_sig)
                        # no change: the decoder's latest frame
                        if view is None:
                            view = dec.latest_view()
                        # the view lives until the next decompress call
                        payload[b, t] = np.asarray(view).reshape(Y, X)
                    else:
                        got = self._guard(b, lambda: _oracle_decode_step(
                            dec, src, dec.is_key_frame(src), X, Y))
                        # quarantined: frozen, changed stays False
                        if got is None:
                            continue
                        sig[b, t], cap = got
                        data = dec.previous_frame()
                        if data is not None:
                            payload[b, t] = data.reshape(Y, X)
                    bts[b, t] = cap["bts"]
                    mv[b, t] = cap["mv"]
                    rect[b, t] = cap["rect"]
                    changed[b, t] = cap["changed"]
        if self.cfg.sp_device_path != "kmv":
            return self._block_route(bts, mv, rect, payload, changed, start)
        with TRACE.span("jsp.prep"):
            pcs, mvks = [], []
            for b in range(B):
                if b in self.quarantined:
                    # frozen slot: its pooled command rows are stale and
                    # changed[b] is all-False — skip the per-pixel prep
                    pcs.append(np.zeros((T, Y, X), dtype=np.uint32))
                    mvks.append(np.zeros((T, K, 2), dtype=np.int32))
                    continue
                pc_b, mvk_b = sp_recon.prepare_kmv(
                    bts[b], mv[b], rect[b], payload[b], K=K)
                pcs.append(pc_b)
                mvks.append(mvk_b)
            pc, mvk = np.stack(pcs), np.stack(mvks)
        return self._plane_route(_PLANE_TRANSPORTS["kmv"], (pc, mvk), changed,
                                 sig, start)

    def _sp_buffers(self, B, T, Y, X, nb) -> dict:
        """The pooled window of captured block commands and payload."""
        return self._buffers(("sp",), lambda: dict(
            bts=np.zeros((B, T, nb), dtype=np.int32),
            mv=np.zeros((B, T, nb, 2), dtype=np.int32),
            rect=np.zeros((B, T, nb, 4), dtype=np.int32),
            payload=np.zeros((B, T, Y, X), dtype=np.uint32),
        ))

    def _plane_buffers(self, tr: _PlaneTransport, lead: tuple) -> dict:
        """The pooled host buffers of a plane transport's window, lead
        (B, T) or, grouped, (B, G, T), once no upload still reads the
        plane: the window is about to refill it.  For a CUDA pipeline the
        plane is page-locked when the pool builds it."""
        vi = self.info
        nb = ((vi.width + 15) // 16) * ((vi.height + 15) // 16)
        pin = self._pins_planes
        # grouped buffers are pooled apart, under G
        key = (tr.name,) if len(lead) == 2 else (tr.name + "g", lead[1])

        def build():
            buf = tr.buffers(lead, vi.height, vi.width, nb, self.cfg.kmv_k)
            if pin:
                pin_host(buf["plane"])
            return dict(buf, guard=[])

        buf = self._buffers(key + (pin,), build)
        if buf["guard"]:
            with TRACE.span("jsp.refill_wait"):
                for ev in buf["guard"]:
                    ev.synchronize()
                buf["guard"].clear()
        return buf

    @property
    def _pins_planes(self) -> bool:
        """Whether the pooled planes are page-locked: the uploads go to a
        CUDA device."""
        return self.device.type == "cuda"

    def _upload_rows(self, plane, rows, counts, device, cpad=None,
                     guard=None) -> torch.Tensor:
        """upload_changed_rows, and an upload_guard in `guard` (the pooled
        plane's) after the copies where they read pinned pages without
        blocking."""
        out = upload_changed_rows(plane, rows, counts, device, cpad)
        if guard is not None and is_pinned(plane):
            guard.append(upload_guard(out.device))
        return out

    def _decode_planes(self, tr: _PlaneTransport, buf, chunk, changed, sig,
                       *g) -> None:
        """The native host stage of a window: frame t of stream b decoded
        into the buffers at [b, *g, t], its changed and significant flags
        into `changed` and `sig` there."""
        K = self.cfg.kmv_k
        decs = self._sp_decoders()
        for b, frames in enumerate(chunk):
            dec = decs[b]
            for t, src in enumerate(frames):
                i = (b, *g, t)
                changed[i], sig[i] = self._guard(
                    b, lambda: tr.decode(dec, src, buf, i, K),
                    default=(False, False))

    def _put(self, a: np.ndarray) -> torch.Tensor:
        return to_device(a, self.device)

    def _model_kw(self) -> dict:
        """The model emission's options, for the fused model scans."""
        return dict(dtype=self._model_dtype,
                    downscale=self.cfg.model_downscale, bpp16=self._bpp16,
                    packed=self.cfg.model_packed)

    def _count_scan(self, scanned: int, changed=None, first: int = 0
                    ) -> None:
        """Counters of a window's device scan: `scanned` rows enter it, and
        those that hold no real frame are padding.  An elided window's
        `changed` [rows, T] says which real frames enter it; its other real
        frames are the stills kept out.  `first` leading frames of each
        stream ride as the scan's init instead."""
        real = len(self.readers) * (self._n_real - first)
        if changed is not None:
            rows = int(changed[:, : self._n_real].sum())
            LOG.count("frames.elided", real - rows)
            real = rows
        LOG.count("frames.scanned", scanned)
        LOG.count("rows.padded", scanned - real)

    def _block_route(self, bts, mv, rect, payload, changed, start) -> dict:
        """The "general" and "pallas" paths: the captured commands and
        payload go to the device as they are, one block-command scan over
        the window (csrc/sp_motion.cu, mode general or fused), significance
        computed on the device.  Like the reference, these paths take no
        still-elision and no model-only emission."""
        decode = (decode_batch_fused if self.cfg.sp_device_path == "pallas"
                  else sp_recon.decode_batch)
        self._count_scan(changed.size)
        with TRACE.span("jsp.scan"):
            frames, signif = decode(
                self._carry_init(bts.shape[0]), self._put(bts),
                self._put(mv), self._put(rect), self._put(payload),
                self._put(changed), 0)
        self._carry = frames[:, -1]
        return self._emit(frames, signif, start)

    def _plane_route(self, tr: _PlaneTransport, arrays, changed, sig,
                     start, guard=None) -> dict:
        """Dispatch an assembled plane-transport window (arrays = (plane
        [B,T,Y,X], *small [B,T,...]), changed/sig [B,T]) to the
        still-elided scans, the sharded mesh step, fused model emission,
        or the dense batch scan.  Shared by both host branches; `guard`
        is a pooled plane's (_plane_buffers)."""
        B = changed.shape[0]
        init = self._carry_init(B)
        mesh = self.cfg.mesh
        if self.cfg.still_elision and (
                mesh is not None or B > 1 or not tr.single_compact):
            return self._plane_elided(tr, arrays, changed, sig, init, start,
                                      guard)
        if self.cfg.still_elision:  # single kmv stream: exact compact scan
            pc, mvk = arrays
            with TRACE.span("jsp.compact"):
                pcc, mvkc, outmap = sp_recon.compact_changed(
                    pc[0], mvk[0], changed[0])
            self._count_scan(pcc.shape[0], changed)
            with TRACE.span("jsp.scan"):
                frames = tr.decode_compact(
                    init[0], self._put(pcc), self._put(mvkc))[None]
            self._carry = frames[:, -1] if pcc.shape[0] else init
            out = {"start_frame": start, "significant": self._put(sig),
                   "frames_u32": frames, "outmap": outmap}
            if self.cfg.emit_model_input:
                out["model_input"] = self._model_tensors(frames)
            return out
        self._count_scan(changed.size)
        if mesh is not None:
            with TRACE.span("jsp.scan"):
                frames = self._sharded_plane_step(tr, arrays[0], arrays[1:],
                                                  changed)
            self._carry = frames[:, -1]
            return self._emit(frames, self._put(sig), start)
        if not self.cfg.emit_frames and self.cfg.emit_model_input:
            with TRACE.span("jsp.scan"):
                carry, model = tr.decode_model(
                    init, *map(self._put, arrays), self._put(changed),
                    **self._model_kw())
            self._carry = carry
            return {"start_frame": start, "significant": self._put(sig),
                    "model_input": model}
        with TRACE.span("jsp.scan"):
            frames = tr.decode_batch(init, *map(self._put, arrays),
                                     self._put(changed))
        self._carry = frames[:, -1]
        return self._emit(frames, self._put(sig), start)

    def _plane_elided(self, tr: _PlaneTransport, arrays, changed, sig, init,
                      start, guard=None) -> dict:
        """Batched still-elision: stills never enter the device scan.

        "frames_u32" (or "model_input" when fused) is a FLAT stack of
        decoded rows and "outmap" [B, T] indexes its first axis (-1 = the
        window's carry-in frame).  Two layouts feed it, chosen per window:

          * CONCAT — when every stream's first compacted slot fully
            overwrites the frame (keyframe-led windows, checked by the
            transport's full_frame), all streams' compacted frames
            concatenate into ONE sequential scan with zero padding;
          * PADDED — otherwise (and always under a mesh), the per-stream
            masked scans of bucketed length Cpad run as one batched scan
            (or shard over the mesh's dp axis) and the [B, Cpad] result is
            flattened with per-stream offsets.

        The compaction plans on frame indices, the small arrays are
        gathered by the plan's rows, and the changed planes go straight
        from the window into a device stack (upload_changed_rows): the
        scan's on one device, each slot's on its own device under a mesh.
        From a pinned plane those copies do not block, and `guard` takes
        their events; every blocking upload of the window is queued before
        them (a blocking copy would wait for them: it synchronises its
        stream)."""
        plane, small = arrays[0], arrays[1:]
        B, T = changed.shape
        mesh = self.cfg.mesh
        with TRACE.span("jsp.compact"):
            # rows: [B, Cpad] indices of the changed frames in the window
            rows, mvkc, valid, outmap = sp_recon.compact_changed_batch(
                np.tile(np.arange(T), (B, 1)), small[-1], changed)
            smallc = [_gather_rows(a, rows, valid)
                      for a in small[:-1]] + [mvkc]
        cpad = rows.shape[1]
        counts = valid.sum(axis=1).astype(np.int64)
        out = {"start_frame": start, "significant": self._put(sig)}
        if cpad == 0:  # all streams all-stills: nothing to decode
            self._count_scan(0, changed)
            return self._all_stills(out, outmap, self.cfg.emit_frames)

        with TRACE.span("jsp.prep"):
            full_first = mesh is None and all(
                counts[b] == 0
                or tr.full_frame(*(a[b, rows[b, 0]] for a in arrays))
                for b in range(B))
        self.stats["concat_windows" if full_first else "padded_windows"] += 1
        if full_first:
            # concat layout: per-stream compacted runs back to back
            with TRACE.span("jsp.prep"):
                offsets = np.zeros(B, dtype=np.int64)
                np.cumsum(counts[:-1], out=offsets[1:])
                cats = [np.concatenate([a[b, : counts[b]] for b in range(B)])
                        for a in smallc]
                outmap_flat = np.where(
                    outmap >= 0, outmap + offsets[:, None],
                    -1).astype(np.int32)
            self._count_scan(int(counts.sum()), changed)
            # (fused model-only emission still decodes the frame stack
            # here: the per-stream carries come from frame rows)
            with TRACE.span("jsp.scan"):
                small_d = [self._put(a) for a in cats]
                frames = tr.decode_compact(
                    init[0], self._upload_rows(plane, rows, counts,
                                               self.device, guard=guard),
                    *small_d)
            ends = offsets + counts  # exclusive
            self._carry = torch.stack([
                frames[int(ends[b]) - 1] if counts[b] else init[b]
                for b in range(B)])
            return self._emit_flat(out, outmap_flat, frames)

        # padded layout (mid-GOP windows or a mesh): [B, Cpad] → flat
        with TRACE.span("jsp.prep"):
            outmap_flat = _padded_outmap(outmap, cpad)
        self._count_scan(valid.size, changed)
        if mesh is None and not self.cfg.emit_frames and \
                self.cfg.emit_model_input:
            # fused: the compacted masked scan emits ONLY model tensors
            with TRACE.span("jsp.scan"):
                small_d = [self._put(a) for a in (*smallc, valid)]
                carry, model = tr.decode_model(
                    init, self._upload_rows(plane, rows, counts,
                                            self.device, cpad, guard),
                    *small_d, **self._model_kw())
            self._carry = carry
            out["outmap"] = outmap_flat
            out["model_input"] = model.reshape((B * cpad,) + model.shape[2:])
            return out
        with TRACE.span("jsp.scan"):
            if mesh is not None:
                # run_bg builds every slot's SlotBuilt input last
                frames = self._sharded_plane_step(tr, SlotBuilt(
                    (B, 1, cpad) + plane.shape[2:],
                    lambda sl, _, dev: self._upload_rows(
                        plane[sl], rows[sl], counts[sl], dev, cpad,
                        guard)[:, None]),
                    smallc, valid)
            else:
                small_d = [self._put(a) for a in (*smallc, valid)]
                frames = tr.decode_batch(
                    init, self._upload_rows(plane, rows, counts,
                                            self.device, cpad, guard),
                    *small_d)
        self._carry = frames[:, -1]
        return self._emit_flat(out, outmap_flat,
                               frames.reshape((-1,) + frames.shape[2:]))

    # -- the bc transport ------------------------------------------------------

    def _decode_sp_window_bc(self, chunk, start, decs) -> dict:
        """bc transport, pure-Python oracle branch: the oracle captures each
        frame's commands and decoded frame, and prepare_bc builds the
        transport into the pooled window.  (The native branch, which fills
        ONLY data-rect plane pixels, is _decode_planes.)"""
        vi = self.info
        X, Y = vi.width, vi.height
        B, T = len(chunk), self.cfg.window
        nb = ((X + 15) // 16) * ((Y + 15) // 16)
        K = self.cfg.kmv_k
        tr = _PLANE_TRANSPORTS["bc"]
        buf = self._plane_buffers(tr, (B, T))
        changed = np.zeros((B, T), dtype=bool)
        sig = np.zeros((B, T), dtype=bool)
        with TRACE.span("jsp.entropy"):
            for b, frames in enumerate(chunk):
                dec = decs[b]
                bts = np.zeros((T, nb), dtype=np.int32)
                mv = np.zeros((T, nb, 2), dtype=np.int32)
                rect = np.zeros((T, nb, 4), dtype=np.int32)
                payload = np.zeros((T, Y, X), dtype=np.uint32)
                for t, src in enumerate(frames):
                    got = self._guard(b, lambda: _oracle_decode_step(
                        dec, src, dec.is_key_frame(src), X, Y))
                    if got is None:  # quarantined: changed stays False
                        continue
                    sig[b, t], cap = got
                    # None until the stream's first real frame: the plane
                    # row stays as it is (changed gating never reads it)
                    data = dec.previous_frame()
                    if data is not None:
                        payload[t] = data.reshape(Y, X)
                    bts[t], mv[t], rect[t] = (cap["bts"], cap["mv"],
                                              cap["rect"])
                    changed[b, t] = cap["changed"]
                (buf["plane"][b], buf["bcode"][b], buf["rloc"][b],
                 buf["mvk"][b]) = sp_recon.prepare_bc(bts, mv, rect, payload,
                                                      K=K)
        return self._plane_route(tr, tr.arrays(buf), changed, sig, start,
                                 buf["guard"])

    # -- the mesh --------------------------------------------------------------

    @property
    def _gop_group(self) -> int:
        """Windows a device dispatch = the mesh's gop-axis size.  Above 1,
        keyframe-led windows are the sequence-parallel unit: G windows of
        one stream decode at once on G slots."""
        mesh = self.cfg.mesh
        if mesh is None:
            return 1
        return mesh.shape.get("gop", 1)

    def _sharded_step(self, attr: str, make, **cfg_kw):
        """The pipeline's sharded step `make(mesh, cfg)`, made once and kept
        under `attr`."""
        if getattr(self, attr, None) is None:
            vi = self.info
            setattr(self, attr, make(self.cfg.mesh, DecodeConfig(
                height=vi.height, width=vi.width, emit_model_input=False,
                **cfg_kw)))
        return getattr(self, attr)

    def _sharded_plane_step(self, tr: _PlaneTransport, plane, small,
                            changed):
        """Plane-transport windows over the mesh's dp axis: [B, T, ...] →
        [B, G=1, T, ...] rows, each slot scanning its own streams'
        P-chains.  `plane` is the host window, or a mesh.SlotBuilt [B, 1,
        T, Y, X] whose slots upload their own rows."""
        if self._gop_group != 1:
            raise ValueError(
                "gop>1 meshes route through the window-grouping path (the "
                "native host stage); a window of a plane transport shards "
                "dp only")
        step = self._sharded_step(f"_{tr.name}_sharded", tr.make_step)
        init = self._carry_init(changed.shape[0])
        if not isinstance(plane, SlotBuilt):
            plane = plane[:, None]
        return step(init[:, None], plane, *(a[:, None] for a in small),
                    changed[:, None])[:, 0]

    def _decode_sp_window_group(self, chunks, starts) -> list[dict]:
        """Decode G keyframe-led windows in ONE sharded [B, G, T] dispatch
        over the (dp, gop) mesh.  Every window after the first must start
        with a keyframe (or be stream-end padding): keyframes make windows
        independent decode chains, so no slot waits on another.  → one
        output dict per real window."""
        vi = self.info
        X, Y = vi.width, vi.height
        G = self._gop_group
        B, T = len(chunks[0]), self.cfg.window
        decs = self._sp_decoders()
        if self.cfg.still_elision:
            raise ValueError(
                "still_elision with a gop>1 mesh is not supported yet")
        tr = _PLANE_TRANSPORTS[self.cfg.sp_device_path]
        buf = self._plane_buffers(tr, (B, G, T))
        changed = np.zeros((B, G, T), dtype=bool)
        sig = np.zeros((B, G, T), dtype=bool)
        with TRACE.span("jsp.entropy"):
            for g, chunk in enumerate(chunks):
                for b, frames in enumerate(chunk):
                    if (g > 0 and frames[0]
                            and not decs[b].is_key_frame(frames[0])):
                        raise ValueError(
                            "gop>1 mesh requires keyframe-led windows "
                            f"(window @{starts[g]} stream {b} starts "
                            "mid-GOP); align IngestConfig.window with the "
                            "keyframe cadence")
                self._decode_planes(tr, buf, chunk, changed, sig, g)
        # g=0 continues the previous group's carry; g>0 windows are
        # keyframe-led, so zeros are exact (the I-frame paints every pixel)
        rows = B if self._carry is None else self._carry.shape[0]
        init = torch.zeros((rows, G, Y, X), dtype=torch.int32,
                           device=self.device)
        if self._carry is not None:
            init[:, 0] = self._carry
        real = B * sum(max(0, min(st + T, self.nframes) - st)
                       for st in starts)
        LOG.count("frames.timeline", real)
        LOG.count("frames.scanned", changed.size)
        LOG.count("rows.padded", changed.size - real)
        step = self._sharded_step(f"_{tr.name}_sharded", tr.make_step)
        with TRACE.span("jsp.scan"):
            frames = step(init, *tr.arrays(buf), changed)
        n_real = len(starts)
        self._carry = frames[:, n_real - 1, -1]
        return [self._emit(frames[:, g], self._put(sig[:, g]), starts[g])
                for g in range(n_real)]

    # -- the kmv_sparse transport ------------------------------------------------

    def _decode_sp_window_sparse(self, chunk, start, decs) -> dict:
        """kmv_sparse, pure-Python oracle branch: the oracle captures each
        frame's commands and decoded frame, prepare_kmv_sparse turns them
        into block codes, K vectors and final-content tiles (dense
        [B, T, M, 16, 16], M padded to a power of two).  Window-leading
        keyframes of every stream ship as the scan's init.

        Reference host fault 3, repaired: a stream quarantined mid-window
        keeps the commands of the frames it decoded before the failure
        (prepared from [t0, t_fail)), then all-copy rows with changed
        False, so its frames freeze at the last good one; the reference
        drops those commands while their `changed` stays True, and writes a
        zero tile into their top-left block."""
        vi = self.info
        X, Y = vi.width, vi.height
        B, T = len(chunk), self.cfg.window
        nb = ((X + 15) // 16) * ((Y + 15) // 16)
        K = self.cfg.kmv_k
        buf = self._sp_buffers(B, T, Y, X, nb)
        bts, mv, rect, payload = (buf["bts"], buf["mv"], buf["rect"],
                                  buf["payload"])
        changed = np.zeros((B, T), dtype=bool)
        sig = np.zeros((B, T), dtype=bool)
        is_key0 = np.zeros(B, dtype=bool)
        frozen = set(self.quarantined)  # before this window
        t_fail = {}  # stream → the step whose decode failed in this window
        with TRACE.span("jsp.entropy"):
            for b, frames in enumerate(chunk):
                dec = decs[b]
                for t, src in enumerate(frames):
                    isk = dec.is_key_frame(src)  # safe byte peek
                    got = self._guard(b, lambda: _oracle_decode_step(
                        dec, src, isk, X, Y))
                    if got is None:  # quarantined: changed stays False
                        if b not in frozen:
                            t_fail.setdefault(b, t)
                        continue
                    sig[b, t], cap = got
                    data = dec.previous_frame()
                    if data is not None:
                        payload[b, t] = data.reshape(Y, X)
                    if t == 0:
                        is_key0[b] = bool(isk)
                    bts[b, t] = cap["bts"]
                    mv[b, t] = cap["mv"]
                    rect[b, t] = cap["rect"]
                    changed[b, t] = cap["changed"]
        # GOP-aligned init: a window-leading keyframe ships as the dense
        # scan init (its tiles would be the whole frame anyway)
        skip0 = bool(is_key0.all())
        t0 = 1 if skip0 else 0

        def all_copy(n, m):
            return (np.zeros((n, nb), np.uint8), np.zeros((n, K, 2), np.int32),
                    np.zeros((n, m, 16, 16), np.uint32),
                    np.zeros((n, m, 2), np.int32))

        def prep(b):
            # frames decoded in this window: [t0, t_end); the rest all-copy
            t_end = T if b not in self.quarantined else (
                t_fail.get(b, t0) if b not in frozen else t0)
            if t_end <= t0:
                return all_copy(T - t0, 1)
            got = sp_recon.prepare_kmv_sparse(
                bts[b, t0:t_end], mv[b, t0:t_end], rect[b, t0:t_end],
                (payload[b, t0:t_end] & np.uint32(0x00FFFFFF)), K=K)
            if t_end == T:
                return got
            rest = all_copy(T - t_end, got[2].shape[1])
            return tuple(np.concatenate([a, r]) for a, r in zip(got, rest))

        def padM(tiles, tyx):
            # prepare_kmv_sparse guarantees M >= 1 with final-content pad
            # tiles, so repeating column 0 is always a correct no-op rewrite
            reps = m_pad - tiles.shape[1]
            if reps == 0:
                return tiles, tyx
            return (np.concatenate([tiles, np.repeat(tiles[:, :1], reps, 1)],
                                   1),
                    np.concatenate([tyx, np.repeat(tyx[:, :1], reps, 1)], 1))

        with TRACE.span("jsp.prep"):
            preps = [prep(b) for b in range(B)]
            m_max = max(1, max(p[2].shape[1] for p in preps))
            m_pad = 1 << (m_max - 1).bit_length()
            bc = np.stack([p[0] for p in preps])
            mvk = np.stack([p[1] for p in preps])
            padded = [padM(p[2], p[3]) for p in preps]
            tiles = np.stack([q[0] for q in padded])
            tyx = np.stack([q[1] for q in padded])
        self._count_scan(changed[:, t0:].size, first=t0)
        with TRACE.span("jsp.scan"):
            init = (self._put(payload[:, 0] & np.uint32(0x00FFFFFF))
                    if skip0 else self._carry_init(B))
            frames = sp_recon.decode_batch_kmv_sparse(
                init, self._put(bc), self._put(mvk), self._put(tiles),
                self._put(tyx), self._put(changed[:, t0:]))
        if skip0:
            frames = torch.cat([init[:, None], frames], dim=1)
        self._carry = frames[:, -1]
        return self._emit(frames, self._put(sig), start)

    def _decode_sp_window_sparse_native(self, chunk, start, decs) -> dict:
        """kmv_sparse, native branch: the C++ decoder fills bcode/mvk/tiles
        straight into a pooled window (decompress_kmv_sparse), the streams
        decoding in threads.  Window-leading keyframes (all streams) ship
        as the dense scan init; other keyframes arrive as full-tile frames.
        Tiles cross as one flat [S, 256] array of each changed frame's real
        tiles and one pad row (raw, or rANS-coded with
        sparse_lane_payload), read on the device through tile_idx."""
        vi = self.info
        X, Y = vi.width, vi.height
        B, T = len(chunk), self.cfg.window
        nb = ((X + 15) // 16) * ((Y + 15) // 16)
        K = self.cfg.kmv_k
        buf = self._buffers(("sparse",), lambda: dict(
            bc=np.zeros((B, T, nb), dtype=np.uint8),
            mvk=np.zeros((B, T, K, 2), dtype=np.int32),
            tiles=np.zeros((B, T, nb, 16, 16), dtype=np.uint32),
            tyx=np.zeros((B, T, nb, 2), dtype=np.int32),
            init=np.zeros((B, Y, X), dtype=np.uint32),
        ))
        bc, mvk, tiles, tyx = buf["bc"], buf["mvk"], buf["tiles"], buf["tyx"]
        changed = np.zeros((B, T), dtype=bool)
        sig = np.zeros((B, T), dtype=bool)
        skip0 = all(len(fr) > 0 and decs[b].is_key_frame(fr[0])
                    for b, fr in enumerate(chunk))
        t0 = 1 if skip0 else 0
        m_used_arr = np.zeros((B, T), dtype=np.int32)

        def host_decode_stream(b):
            dec = decs[b]
            for t, src in enumerate(chunk[b]):
                if t == 0 and skip0:
                    # guarded like every other step: a malformed keyframe
                    # quarantines slot b instead of escaping the thread pool
                    got = self._guard(
                        b, lambda: dec.decompress(src, True, copy=False))
                    if got is None:  # quarantined: init filled from carry
                        continue
                    view, _, _ = got
                    if view is None:
                        view = dec.latest_view()
                    buf["init"][b] = np.asarray(view).reshape(Y, X)
                    buf["init"][b] &= np.uint32(0x00FFFFFF)
                    changed[b, 0] = True
                    sig[b, 0] = True
                    continue
                chg, sg, m_used = self._guard(
                    b, lambda: dec.decompress_kmv_sparse(
                        src, dec.is_key_frame(src), bc[b, t], mvk[b, t],
                        tiles[b, t], tyx[b, t], K=K),
                    default=(False, False, 0))
                changed[b, t] = chg
                sig[b, t] = sg
                if chg:
                    m_used_arr[b, t] = max(1, m_used)

        with TRACE.span("jsp.entropy"):
            if B > 1:
                # the native calls release the GIL; each thread owns
                # disjoint buffer rows
                from concurrent.futures import ThreadPoolExecutor
                import os as _os

                with ThreadPoolExecutor(min(B, _os.cpu_count() or 1)) as ex:
                    list(ex.map(host_decode_stream, range(B)))
            else:
                host_decode_stream(0)
        if skip0 and self.quarantined:
            # a stream whose window-leading KEYFRAME failed (or that was
            # quarantined before this window) starts from its carry, not
            # the pooled init row; one quarantined MID-window keeps its
            # decoded keyframe (changed[b, 0]), which its earlier frames
            # composed against
            prev = (carry_to_numpy(self._carry) if self._carry is not None
                    else np.zeros((B, Y, X), dtype=np.uint32))
            for b in self.quarantined:
                if b < B and not changed[b, 0]:
                    buf["init"][b] = prev[b]
        m_max = max(1, int(m_used_arr.max()))
        m_pad = 1 << (m_max - 1).bit_length()
        # sticky bucket, as the reference keeps it (its jit keys)
        m_pad = min(max(m_pad, getattr(self, "_m_bucket", 1)), nb)
        self._m_bucket = m_pad
        init = (self._put(buf["init"]) if skip0 else self._carry_init(B))
        with TRACE.span("jsp.prep"):
            # ragged tile transfer: only real tiles (+1 pad row per changed
            # frame)
            flat_rows = []
            tile_idx = np.zeros((B, T - t0, m_pad), dtype=np.int32)
            off = 0
            for b in range(B):
                for t in range(t0, T):
                    if not changed[b, t]:
                        continue
                    take = min(int(m_used_arr[b, t]) + 1, nb)  # +1 = pad row
                    flat_rows.append(tiles[b, t, :take].reshape(take, 256))
                    j = np.minimum(np.arange(m_pad), take - 1)
                    tile_idx[b, t - t0] = off + j
                    off += take
            flat = (np.concatenate(flat_rows, axis=0) if flat_rows
                    else np.zeros((1, 256), np.uint32))
        self._count_scan(changed[:, t0:].size, first=t0)
        with TRACE.span("jsp.scan"):
            if self.cfg.sparse_lane_payload and flat.shape[0] > 1:
                # tile pixels cross the link rANS-coded and are lane-decoded
                # on the device
                from ..kernels import lane_transport as _lt

                with TRACE.span("jsp.prep"):
                    pack = _lt.encode_tiles(flat & np.uint32(0x00FFFFFF))
                flat_dev = _lt.decode_tiles_device(pack, self.device)
            else:
                flat_dev = self._put(flat)
            frames = sp_recon.decode_batch_kmv_sparse_ragged(
                init, self._put(bc[:, t0:]), self._put(mvk[:, t0:]),
                flat_dev, self._put(tile_idx),
                self._put(tyx[:, t0:, :m_pad]), self._put(changed[:, t0:]))
        if skip0:
            frames = torch.cat([init[:, None], frames], dim=1)
        self._carry = frames[:, -1]
        return self._emit(frames, self._put(sig), start)

    # -- MSVideo1 --------------------------------------------------------------

    def _decode_msv1_window(self, chunk, start) -> dict:
        """MSV1: each frame parsed into per-block commands on the host
        (native, or the oracle's parse_commands), then one msv1_paint
        launch paints the window of every stream."""
        vi = self.info
        X, Y = vi.width, vi.height
        B, T = len(chunk), self.cfg.window
        nb = (X >> 2) * (Y >> 2)
        with TRACE.span("jsp.prep"):
            bt = np.zeros((B, T, nb), dtype=np.uint8)
            sel = np.zeros((B, T, nb, 16), dtype=np.uint8)
            col = np.zeros((B, T, nb, 8), dtype=np.uint32)
            chg = np.zeros((B, T), dtype=bool)
        from .. import native as _native

        parse = (_native.native_msv1_parse if _native.available()
                 else parse_commands)
        with TRACE.span("jsp.entropy"):
            for b, frames in enumerate(chunk):
                for t, src in enumerate(frames):
                    # a malformed MSV1 stream quarantines its slot (frozen
                    # at the last good frame) instead of failing the batch
                    got = self._guard(b, lambda: parse(
                        src, X, Y, pal=self._pals[b]))
                    if got is None:
                        continue
                    bt[b, t], sel[b, t], col[b, t], chg[b, t] = got
        init = self._carry_init(B)
        il = self.cfg.insignificant_lines
        with TRACE.span("jsp.prep"):
            sel = msv1_paint.sel_to_plane(sel, Y, X)  # the device's order
        self._count_scan(chg.size)
        with TRACE.span("jsp.scan"):
            if self.cfg.mesh is not None:
                frames, signif = self._sharded_msv1_window(init, start, bt,
                                                           sel, col, chg)
            else:
                # as the reference: valid when the window is not the
                # stream's first
                valid = torch.full((B,), start > 0, dtype=torch.bool,
                                   device=self.device)
                frames, signif = msv1_paint.decode_batch(
                    init, valid, self._put(bt), self._put(sel),
                    self._put(col), self._put(chg), (il + 3) >> 2, il,
                    X // 4)
        self._carry = frames[:, -1]
        return self._emit(frames, signif, start)

    def _sharded_msv1_window(self, init, start, bt, sel, col, chg):
        """MSV1 windows over the mesh's dp axis (streams sharded), the
        window carry threaded through the sharded step."""
        from .batch import make_msv1_decode_step

        if self._gop_group != 1:
            raise ValueError(
                "gop>1 grouping is implemented for the SP kmv path only")
        il = self.cfg.insignificant_lines
        step = self._sharded_step(
            "_msv1_sharded",
            lambda mesh, cfg: make_msv1_decode_step(mesh, cfg,
                                                    with_carry=True),
            insignificant_blocks=(il + 3) >> 2, insignificant_lines=il)
        valid = np.full((bt.shape[0], 1), start > 0)
        frames, signif = step(init[:, None], valid, bt[:, None],
                              sel[:, None], col[:, None], chg[:, None])
        return frames[:, 0], signif[:, 0]

    def audio_pcm(self):
        """Per-stream time-aligned PCM tensors (or None where the stream has
        no audio) — the decoded counterpart of :attr:`audio_tracks`, so A/V
        consumers get ``[n_samples, ch]`` float32 next to the video model
        tensors (SURVEY.md §7 step 9; the reference's WebAudio decode,
        AudioTrack.hx:54-65, delegated here to the system codec backend).
        Decoded once and cached; requires av.pcm.available()."""
        if self._pcm_cache is None:
            from ..av import pcm as _pcm
            self._pcm_cache = _pcm.decode_tracks(self.audio_tracks)
        return self._pcm_cache

    # -- lane containers -------------------------------------------------------

    def _init_lane(self, sources) -> None:
        """Lane-container batch: parse headers, check shared geometry."""
        from ..codecs import lane_format

        if self.cfg.streaming:
            # containers are meta-deflated and small; whole-blob load IS
            # the residency model — reject the flag instead of silently
            # ignoring it
            raise ValueError("sp_device_path='lane' loads whole containers; "
                             "streaming=True is the long-AVI mode")
        self.containers = []
        for s in sources:
            data = s.read_range(0)
            if not lane_format.is_lane_container(data):
                raise ValueError(
                    "sp_device_path='lane' needs lane-container sources "
                    "(transcode.transcode_to_lane), not AVIs")
            self.containers.append(lane_format.container_from_bytes(data))
        c0 = self.containers[0]
        for c in self.containers:
            assert (c.X, c.Y, c.K, c.n_lanes, c.window) == (
                c0.X, c0.Y, c0.K, c0.n_lanes, c0.window), \
                "lane batch must share geometry, K, lanes, and window size"
        self.info = VideoInfo(width=c0.X, height=c0.Y, bpp=c0.bpp,
                              fps=c0.fps, nframes=c0.n_frames,
                              codec=CodecType.SCREENPRESSOR)
        self.nframes = max(c.n_frames for c in self.containers)
        self._bpp16 = c0.bpp == 16
        # MP3 audio passthrough: AudioTracks rebuilt from the containers'
        # raw sound streams (the Mp3Parser → sections wiring the AVI
        # loader uses)
        self.audio_tracks = [self._lane_audio(c) for c in self.containers]
        self._pcm_cache = None
        self.quarantined = set()
        self.quarantine_errors = []

    @staticmethod
    def _lane_audio(container):
        if not container.audio:
            return None
        from ..av.audio_track import AudioTrack
        from ..av.mp3 import Mp3Parser
        from ..core.chunkbuffer import ChunkBuffer

        track = AudioTrack()
        buf = ChunkBuffer()
        parser = Mp3Parser(
            buf, lambda start, data, last: track.add_section(
                parser.sections[-1]))
        buf.add_chunk(container.audio)
        parser.parse()
        parser.on_data_end()
        parser.parse()
        return track

    def _lane_window_starts(self):
        """→ (true window lengths, their frame bases, first window, end
        window).  Streams of a batch must share window boundaries (the
        [B, T] batching keeps one timeline); frame_range starts at the
        latest window ≤ t0 that is a restart in every stream (the
        container's keyframe unit) and ends once t1 is covered."""
        with TRACE.span("jsp.demux"):
            Tw = self.containers[0].window
            n_windows = max(len(c.windows) for c in self.containers)
            Ts: list[int] = []
            for wj in range(n_windows):
                tlen = None
                for c in self.containers:
                    if wj < len(c.windows):
                        if tlen is None:
                            tlen = c.windows[wj].T
                        elif c.windows[wj].T != tlen:
                            raise ValueError(
                                "lane batch streams have mismatched window "
                                f"boundaries at window {wj}")
                Ts.append(Tw if tlen is None else tlen)
            bases = np.concatenate([[0], np.cumsum(Ts)]).astype(int)
            wi0, wi_end = 0, n_windows
            if self.cfg.frame_range is not None:
                t0, t1 = self.cfg.frame_range
                tt0 = max(0, min(int(t0), self.nframes - 1))
                want = max(0, int(np.searchsorted(bases, tt0,
                                                  side="right")) - 1)
                wi0 = 0
                for wi in range(want, -1, -1):
                    if all(wi < len(c.windows) and c.windows[wi].restart
                           for c in self.containers):
                        wi0 = wi
                        break
                tt1 = max(t0 + 1, int(t1))
                wi_end = min(n_windows,
                             int(np.searchsorted(bases, tt1, side="left")))
            return Ts, bases, wi0, wi_end

    def _lane_group(self, wi: int, ts: list, raw: bool) -> dict:
        """Windows wi .. wi+G-1 (G = len(ts), their true lengths) of every
        stream, padded to shared buckets → host arrays over the B*G entries
        (stream-major: entry b*G + g is stream b's window wi+g): btype
        [BG, Tpad, NB], rect, mvk, row_idx [BG, Tpad, Y], changed [BG,
        Tpad], sig [B, sum(ts)], row_table [BG, ur_pad, ncol], payload [BG,
        u_pad, 3, 128] (raw) or refills [BG, steps, N, 2], states, freq
        (rans), init planes (rans restart windows, else None), u_pad.  Tpad,
        u_pad, ur_pad and steps are powers of two (steps at least the
        widest window's); pad frames are unchanged stills, pad rows and
        units are never referenced, and an entry without a window passes
        its carry through."""
        from ..codecs.lane_format import plane_cols
        from ..kernels import rans_lanes as _rl

        c0 = self.containers[0]
        B, G = len(self.containers), len(ts)
        BG = B * G
        Y, X, K, N = c0.Y, c0.X, c0.K, c0.n_lanes
        ncol = plane_cols(X) // 128
        nb = ((X + 15) // 16) * ((Y + 15) // 16)
        wins = [c.windows[wi + g] if wi + g < len(c.windows) else None
                for c in self.containers for g in range(G)]
        offs = np.concatenate([[0], np.cumsum(ts)]).astype(int)
        Tpad = _pow2ceil(max(ts))
        h = dict(btype=np.zeros((BG, Tpad, nb), dtype=np.uint8),
                 rect=np.zeros((BG, Tpad, nb, 4), dtype=np.uint8),
                 mvk=np.zeros((BG, Tpad, K, 2), dtype=np.int32),
                 row_idx=np.zeros((BG, Tpad, Y), dtype=np.int32),
                 changed=np.zeros((BG, Tpad), dtype=bool),
                 sig=np.zeros((B, int(offs[-1])), dtype=bool))
        rtabs = [None] * BG
        for e, w in enumerate(wins):
            if w is None:
                continue
            b, g = divmod(e, G)
            h["btype"][e, : w.T] = w.btype
            h["rect"][e, : w.T] = w.rect
            h["mvk"][e, : w.T] = w.mvk
            rtabs[e], h["row_idx"][e, : w.T] = w.row_index(Y, ncol)
            h["changed"][e, : w.T] = w.changed
            h["sig"][b, offs[g]: offs[g] + w.T] = w.signif
        ur_pad = _pow2ceil(max((rt.shape[0] for rt in rtabs
                                if rt is not None), default=1))
        h["row_table"] = np.zeros((BG, ur_pad, ncol), dtype=np.int32)
        for e, rt in enumerate(rtabs):
            if rt is not None:
                h["row_table"][e, : rt.shape[0]] = rt
        h["u_pad"] = u_pad = _pow2ceil(max(
            w.n_units if w is not None else 0 for w in wins))
        if raw:
            h["payload"] = np.zeros((BG, u_pad, 3, 128), dtype=np.uint8)
            for e, w in enumerate(wins):
                if w is not None and w.n_units:
                    h["payload"][e, : w.n_units] = w.payload
        else:
            need_steps = -(-3 * u_pad * 128 // N)
            steps = max(_pow2ceil(need_steps),
                        max((w.refills.shape[0] for w in wins
                             if w is not None), default=1))
            h["refills"] = np.zeros((BG, steps, N, 2), dtype=np.uint8)
            h["states"] = np.zeros((BG, N), dtype=np.uint32)
            # a valid table for absent rows: the kernel needs one
            h["freq"] = np.ones((BG, 256), dtype=np.int32)
            h["freq"][:, 0] += _rl.PROB_SCALE - 256
            for e, w in enumerate(wins):
                if w is None:
                    continue
                h["refills"][e, : w.refills.shape[0]] = w.refills
                h["states"][e] = w.states
                h["freq"][e] = w.freq
        h["init"] = None
        if any(w is not None and w.init_plane is not None for w in wins):
            h["init"] = [None if w is None else w.init_plane for w in wins]
        return h

    def _local_rows(self, a: np.ndarray, n: int, G: int = 1) -> np.ndarray:
        """A global host array over n streams (x G entries each) → the
        rows of this process's streams (all of them with one process)."""
        if self.cfg.mesh is None:
            return a
        rows = self.cfg.mesh.local_rows(n)
        return a[rows.start * G: rows.stop * G]

    def _iter_lane(self) -> Iterator[dict]:
        """Device-entropy ingest: per window group, pad streams to shared
        buckets (_lane_group) and run the lane decode of every entry on the
        device (kernels/lane_recon): the rows, then one lane_compose launch
        a scan step for all entries (on each slot of the mesh when there is
        one).  The host's only per-frame work is array slicing; the carry
        stays on the device.

        GOP axis: when the mesh has a gop axis (>1), up to `gop`
        CONSECUTIVE windows join one dispatch — valid because every
        non-leading window in a group is a restart (frame 0 fully paints
        the plane, so its decode is carry-independent).  Entries are
        stream-major, so the group emits as ONE dict covering its frames:
        the same consumer contract (start_frame + flat outmap), a bigger
        window."""
        from ..kernels import lane_recon

        c0 = self.containers[0]
        B = len(self.containers)
        Y, X = c0.Y, c0.X
        windows = [w for c in self.containers for w in c.windows]
        raw = any(w.raw_mode for w in windows)
        if raw and not all(w.raw_mode for w in windows):
            raise ValueError("lane batch mixes raw and rans payload windows")
        Ts, bases, wi, wi_end = self._lane_window_starts()
        mesh = self.cfg.mesh
        gop_size = self._gop_group

        def all_restart(wj):
            return all(c.windows[wj].restart for c in self.containers
                       if wj < len(c.windows))

        pending = None
        while wi < wi_end:
            TRACE.poll()
            with TRACE.span("jsp.window", (self._serial, int(bases[wi]))):
                # greedy group: extend while the next window is carry-free
                G = 1
                while (G < gop_size and wi + G < wi_end
                       and all_restart(wi + G)):
                    G += 1
                ts = Ts[wi: wi + G]
                total_real = sum(ts)
                LOG.count("frames.timeline", B * total_real)
                with TRACE.span("jsp.prep"):
                    h = self._lane_group(wi, ts, raw)
                # every entry starts from its stream's carry (restart
                # entries ignore it; absent entries pass it through)
                init = self._carry_init(B)
                if G > 1:
                    init = init.repeat_interleave(G, dim=0)
                # rans mode: window-leading keyframes ride as raw init
                # planes (the scan's frame 0 is an all-copy passthrough):
                # those entries start from their plane, on the device
                if h["init"] is not None:
                    with TRACE.span("jsp.prep"):
                        mask = np.array([p is not None for p in h["init"]])
                        planes = np.stack([
                            np.zeros((Y, X), np.uint32) if p is None else p
                            for p in h["init"]])
                        init = torch.where(
                            self._put(self._local_rows(mask, B, G))[
                                :, None, None],
                            self._put(self._local_rows(planes, B, G)), init)
                btype, rect, mvk, row_idx = (h[k] for k in (
                    "btype", "rect", "mvk", "row_idx"))
                changed = h["changed"]
                # still-elision: stills never enter the lane scan (the flat
                # row stack + outmap contract of _plane_elided; -1 = the
                # window's carry-in frame)
                outmap = None
                if self.cfg.still_elision:
                    with TRACE.span("jsp.compact"):
                        (btype, rect, mvk, row_idx), changed, outmap = \
                            sp_recon.compact_arrays_batch(
                                (btype, rect, mvk, row_idx), changed)
                    with TRACE.span("jsp.prep"):
                        om = _padded_outmap(outmap, btype.shape[1])
                        # ragged windows: keep only each window's real
                        # frames
                        outmap = np.stack([
                            np.concatenate([om[b * G + g, : ts[g]]
                                            for g in range(G)])
                            for b in range(B)])
                    real = int(changed.sum())
                    LOG.count("frames.elided", B * total_real - real)
                else:  # the real frames of the windows present
                    real = sum(c.windows[wi + g].T for c in self.containers
                               for g in range(G) if wi + g < len(c.windows))
                LOG.count("frames.scanned", changed.size)
                LOG.count("rows.padded", changed.size - real)
                if changed.shape[1] == 0:  # all streams all-stills
                    # (as the reference's lane path: the empty row stack
                    # whatever emit_frames says)
                    out = self._all_stills(
                        {"start_frame": int(bases[wi]),
                         "significant": self._put(h["sig"])}, outmap, True)
                else:
                    cmds = (btype, rect, mvk, h["row_table"], row_idx,
                            changed)
                    data = ((h["payload"],) if raw else
                            tuple(h[k] for k in ("refills", "states",
                                                 "freq")))
                    with TRACE.span("jsp.scan"):
                        if mesh is not None:
                            frames = lane_recon.make_lane_decode_step(
                                mesh, h["u_pad"], raw=raw,
                                axes=("dp", "gop") if G > 1 else ("dp",))(
                                    init, *data, *cmds)
                        elif raw:
                            frames = lane_recon.decode_batch_raw(
                                init, *map(self._put, data + cmds))
                        else:
                            frames = lane_recon.decode_batch_lane(
                                init, *map(self._put, data + cmds),
                                h["u_pad"])
                    # a stream's carry: its last entry's last frame
                    self._carry = frames[G - 1:: G, -1]
                    out = {"start_frame": int(bases[wi]),
                           "significant": self._put(h["sig"])}
                    if outmap is not None:
                        self._emit_flat(
                            out, outmap,
                            frames.reshape((-1,) + frames.shape[2:]))
                    else:
                        # [B*G, Tpad, ...] → [B, G*T, ...]: stream-major
                        # entries read as one window; ragged
                        # (keyframe-snapped) windows keep only their real
                        # frames
                        if G == 1:
                            frames = frames[:, :ts[0]]
                        else:
                            frames = torch.cat([frames[g:: G, :ts[g]]
                                                for g in range(G)], dim=1)
                        out["frames_u32"] = frames
                        if self.cfg.emit_model_input:
                            out["model_input"] = self._model_tensors(frames)
            if pending is not None:
                yield pending
            pending = out
            wi += G
        if pending is not None:
            yield pending

    # -- shared ----------------------------------------------------------------

    def _carry_init(self, B) -> torch.Tensor:
        if self._carry is None:
            vi = self.info
            return torch.zeros((B, vi.height, vi.width), dtype=torch.int32,
                               device=self.device)
        return self._carry

    def _model_tensors(self, frames):
        """Frames → the configured model product (unpacked tensors or the
        packed-ds2 plane)."""
        with TRACE.span("jsp.epilogue"):
            if self.cfg.model_packed:
                if self.cfg.model_downscale != 2:
                    raise ValueError(
                        "model_packed requires model_downscale == 2")
                return ds2_packed_output(frames)
            return to_model_input(
                frames, dtype=self._model_dtype,
                downscale=self.cfg.model_downscale, bpp16=self._bpp16)

    def _all_stills(self, out: dict, outmap, emit_frames: bool) -> dict:
        """An elided window whose streams are all stills: nothing is
        decoded, outmap (all -1) indexes an empty row stack."""
        out["outmap"] = outmap
        if emit_frames:
            vi = self.info
            out["frames_u32"] = torch.zeros(
                (0, vi.height, vi.width), dtype=torch.int32,
                device=self.device)
        return out

    def _emit_flat(self, out: dict, outmap, flat) -> dict:
        """An elided window's emission: the flat row stack `flat` and the
        outmap [B, T] that indexes it (-1 = the carry-in frame)."""
        out["outmap"] = outmap
        if self.cfg.emit_frames:
            out["frames_u32"] = flat
        if self.cfg.emit_model_input:
            out["model_input"] = self._model_tensors(flat)
        return out

    def _emit(self, frames, signif, start) -> dict:
        out = {"start_frame": start, "frames_u32": frames,
               "significant": signif}
        if self.cfg.emit_model_input:
            out["model_input"] = self._model_tensors(frames)
        return out

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
    reference.

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
imports jax at the top, which this package never does.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from ..core.loader import DataLoaderAVISeq
from ..core.source import ByteSource
from ..core.types import CodecType, VideoInfo
from ..device import resolve_device, to_device, torch_to_u32
from ..codecs.msvideo1 import palette_to_u32, parse_commands
from ..kernels import msv1_paint, sp_recon
from ..kernels.rgb_convert import ds2_packed_output, to_model_input
from ..kernels.sp_motion_pallas import decode_batch_fused

#: the sp_device_path values (the reference's); another raises ValueError
PORTED_SP_PATHS = ("kmv", "bc", "kmv_sparse", "general", "pallas", "lane")

# Process-wide host-buffer pool: window buffers are hundreds of MB and fresh
# pages fault in slowly, so a new pipeline re-allocating them costs more
# than the decode itself.  Buffers are checked out exclusively (popped)
# while a pipeline iterates and returned when its iterator finishes.  A
# pooled kmv plane travels with its `dirty` incremental-fill state under
# one key: the native fill trusts `dirty` to say what the plane holds.
_BUFFER_POOL: dict = {}


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
        for _ in range(100000):
            before = self.loader.mp3_parser.frames_processed
            self.loader.parse_sound()
            if self.loader.mp3_parser.frames_processed == before:
                break
        self.loader.mp3_parser.on_data_end()
        self.loader.parse_sound()
        if self.loader.video_info is None:
            raise ValueError(
                "no video header found (file truncated before avih/strf?)")
        self.info: VideoInfo = self.loader.video_info
        self.frames: list[bytes] = [
            (f.data if f is not None and f.data is not None else b"")
            for f in self.loader.frames
        ]
        self.audio_track = self.loader.audio_track

    # -- streaming mode ------------------------------------------------------

    def fetch_upto(self, hi: int) -> None:
        """Pump the demuxer until frame `hi` (exclusive) is parsed or EOF;
        the MP3 scanner rides along.  Progress is the PARSE watermark."""
        while not self.eof and self.loader.loaded_frames_end() < hi:
            if not self.loader.pump():
                self.eof = True
            self.loader.parse_sound()
        if self.eof and not self.loader.mp3_parser.parsing_complete:
            self.loader.parse_sound()

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
        self.cfg = config or IngestConfig()
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
        if self.cfg.sp_device_path == "lane":
            self._init_lane(sources)
            return
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
                    out = self._decode_window(chunk, start)
                    for r in self.readers:
                        r.release_upto(start + W)  # O(window) residency
                    self.nframes = max(self.nframes,
                                       *(r.available() for r in self.readers))
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
                    and self.cfg.sp_device_path in ("kmv", "bc")
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
                    yield from self._decode_sp_window_group(chunks, grp)
                return
            starts = self._window_starts()
            for i, start in enumerate(starts):
                # keyframe-aligned windows may be shorter than W: decode
                # [start, end), pad the chunk to W with no-change frames,
                # trim the emission
                end = starts[i + 1] if i + 1 < len(starts) else start + W
                chunk = []
                for r in self.readers:
                    frames = r.frames[start:end]
                    frames += [b""] * (W - len(frames))  # empty = no change
                    chunk.append(frames)
                out = self._decode_window(chunk, start)
                if end - start < W:
                    out = _trim_window(out, end - start)
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

    def _release_buffers(self):
        # uploads are blocking copies (device.to_device), so no device work
        # still reads these host pages
        for attr, key in (("_spbuf", ("sp",)), ("_kmvbuf", ("kmv",)),
                          ("_kmvgbuf", ("kmvg", self._gop_group)),
                          ("_sparsebuf", ("sparse",)), ("_bcbuf", ("bc",)),
                          ("_bcgbuf", ("bcg", self._gop_group))):
            buf = getattr(self, attr, None)
            if buf is not None:
                _pool_release(key + self._buf_key, buf)
                setattr(self, attr, None)

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
        if self.cfg.sp_device_path == "bc":
            return self._decode_sp_window_bc(chunk, start, decs)
        if self.cfg.sp_device_path == "kmv" and self._sp_native:
            # the native decoder emits the kmv transport during decode
            if getattr(self, "_kmvbuf", None) is None:
                # dirty rows carry each pooled plane's incremental-fill
                # state across windows AND pipelines (they live with it)
                self._kmvbuf = _pool_acquire(
                    ("kmv",) + self._buf_key, lambda: dict(
                        pc=np.zeros((B, T, Y, X), dtype=np.uint32),
                        mvk=np.zeros((B, T, K, 2), dtype=np.int32),
                        dirty=np.zeros((B, T, nb + 1), dtype=np.int32)))
            pc, mvk = self._kmvbuf["pc"], self._kmvbuf["mvk"]
            dirty = self._kmvbuf["dirty"]
            changed = np.zeros((B, T), dtype=bool)
            sig = np.zeros((B, T), dtype=bool)
            for b, frames in enumerate(chunk):
                dec = decs[b]
                for t, src in enumerate(frames):
                    changed[b, t], sig[b, t] = self._guard(
                        b, lambda: dec.decompress_kmv(
                            src, dec.is_key_frame(src), pc[b, t], mvk[b, t],
                            K=K, dirty=dirty[b, t]), default=(False, False))
            return self._kmv_route(pc, mvk, changed, sig, start)
        # command capture (bts/mv/rect + the decoded frame as payload) by
        # the native decoder or the pure-Python oracle; window buffers are
        # reused across iterations
        if getattr(self, "_spbuf", None) is None:
            self._spbuf = _pool_acquire(("sp",) + self._buf_key, lambda: dict(
                bts=np.zeros((B, T, nb), dtype=np.int32),
                mv=np.zeros((B, T, nb, 2), dtype=np.int32),
                rect=np.zeros((B, T, nb, 4), dtype=np.int32),
                payload=np.zeros((B, T, Y, X), dtype=np.uint32),
            ))
        buf = self._spbuf
        bts, mv, rect, payload = buf["bts"], buf["mv"], buf["rect"], buf["payload"]
        changed = np.zeros((B, T), dtype=bool)
        sig = np.zeros((B, T), dtype=bool)
        for b, frames in enumerate(chunk):
            dec = decs[b]
            for t, src in enumerate(frames):
                if self._sp_native:
                    isk = dec.is_key_frame(src)
                    got = self._guard(b, lambda: dec.decompress(
                        src, isk, capture=True, copy=False))
                    if got is None:  # quarantined: frozen at last good frame
                        continue
                    view, _sig, cap = got
                    sig[b, t] = bool(_sig)
                    if view is None:  # no change: the decoder's latest frame
                        view = dec.latest_view()
                    # the view lives until the next decompress call
                    payload[b, t] = np.asarray(view).reshape(Y, X)
                else:
                    got = self._guard(b, lambda: _oracle_decode_step(
                        dec, src, dec.is_key_frame(src), X, Y))
                    if got is None:  # quarantined: frozen, changed stays False
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
        return self._kmv_route(np.stack(pcs), np.stack(mvks), changed, sig,
                               start)

    def _put(self, a: np.ndarray) -> torch.Tensor:
        return to_device(a, self.device)

    def _block_route(self, bts, mv, rect, payload, changed, start) -> dict:
        """The "general" and "pallas" paths: the captured commands and
        payload go to the device as they are, one block-command scan over
        the window (csrc/sp_motion.cu, mode general or fused), significance
        computed on the device.  Like the reference, these paths take no
        still-elision and no model-only emission."""
        decode = (decode_batch_fused if self.cfg.sp_device_path == "pallas"
                  else sp_recon.decode_batch)
        frames, signif = decode(
            self._carry_init(bts.shape[0]), self._put(bts), self._put(mv),
            self._put(rect), self._put(payload), self._put(changed), 0)
        self._carry = frames[:, -1]
        return self._emit(frames, signif, start)

    def _kmv_route(self, pc, mvk, changed, sig, start) -> dict:
        """Dispatch an assembled kmv window (pc [B,T,Y,X], mvk [B,T,K,2],
        changed/sig [B,T]) to the sharded mesh step, still-elided scans,
        fused model emission, or the dense batch scan.  Shared by both host
        branches."""
        B = pc.shape[0]
        init = self._carry_init(B)
        if self.cfg.still_elision and (self.cfg.mesh is not None or B > 1):
            return self._kmv_elided(pc, mvk, changed, sig, init, start)
        if self.cfg.mesh is not None:
            frames = self._sharded_kmv_step(pc, mvk, changed)
            self._carry = frames[:, -1]
            return self._emit(frames, self._put(sig), start)
        if self.cfg.still_elision:  # single stream: exact compact scan
            pcc, mvkc, outmap = sp_recon.compact_changed(
                pc[0], mvk[0], changed[0])
            frames = sp_recon.decode_sequence_kmv_compact(
                init[0], self._put(pcc), self._put(mvkc))[None]
            self._carry = frames[:, -1] if pcc.shape[0] else init
            out = {"start_frame": start, "significant": self._put(sig),
                   "frames_u32": frames, "outmap": outmap}
            if self.cfg.emit_model_input:
                out["model_input"] = self._model_tensors(frames)
            return out
        if not self.cfg.emit_frames and self.cfg.emit_model_input:
            carry, model = sp_recon.decode_batch_kmv_model(
                init, self._put(pc), self._put(mvk), self._put(changed),
                dtype=self._model_dtype,
                downscale=self.cfg.model_downscale, bpp16=self._bpp16,
                packed=self.cfg.model_packed)
            self._carry = carry
            return {"start_frame": start, "significant": self._put(sig),
                    "model_input": model}
        frames = sp_recon.decode_batch_kmv(
            init, self._put(pc), self._put(mvk), self._put(changed))
        self._carry = frames[:, -1]
        return self._emit(frames, self._put(sig), start)

    def _kmv_elided(self, pc, mvk, changed, sig, init, start) -> dict:
        """Batched still-elision: stills never enter the device scan.

        "frames_u32" (or "model_input" when fused) is a FLAT stack of
        decoded rows and "outmap" [B, T] indexes its first axis (-1 = the
        window's carry-in frame).  Two layouts feed it, chosen per window:

          * CONCAT — when every stream's first compacted slot fully
            overwrites the frame (keyframe-led windows, checked on the
            paycode ptype plane), all streams' compacted frames
            concatenate into ONE sequential scan with zero padding;
          * PADDED — otherwise (and always under a mesh), the per-stream
            masked scans of bucketed length Cpad run as one batched scan
            (or shard over the mesh's dp axis) and the [B, Cpad] result is
            flattened with per-stream offsets."""
        B = pc.shape[0]
        vi = self.info
        pcc, mvkc, valid, outmap = sp_recon.compact_changed_batch(
            pc, mvk, changed)
        cpad = pcc.shape[1]
        counts = valid.sum(axis=1).astype(np.int64)
        out = {"start_frame": start, "significant": self._put(sig)}
        if cpad == 0:  # all streams all-stills: nothing to decode
            out["outmap"] = outmap  # all -1
            if self.cfg.emit_frames:
                out["frames_u32"] = torch.zeros(
                    (0, vi.height, vi.width), dtype=torch.int32,
                    device=self.device)
            return out

        full_first = self.cfg.mesh is None and all(
            counts[b] == 0
            or bool((((pcc[b, 0] >> 24) & 3) == 1).all())
            for b in range(B))
        self.stats["concat_windows" if full_first else "padded_windows"] += 1
        if full_first:
            # concat layout: per-stream compacted runs back to back
            offsets = np.zeros(B, dtype=np.int64)
            np.cumsum(counts[:-1], out=offsets[1:])
            cat_pc = np.concatenate(
                [pcc[b, : counts[b]] for b in range(B)] or
                [np.zeros((0,) + pcc.shape[2:], pcc.dtype)])
            cat_mv = np.concatenate(
                [mvkc[b, : counts[b]] for b in range(B)])
            outmap_flat = np.where(
                outmap >= 0, outmap + offsets[:, None], -1).astype(np.int32)
            # (fused model-only emission still decodes the frame stack
            # here: the per-stream carries come from frame rows)
            frames = sp_recon.decode_sequence_kmv_compact(
                init[0], self._put(cat_pc), self._put(cat_mv))
            ends = offsets + counts  # exclusive
            self._carry = torch.stack([
                frames[int(ends[b]) - 1] if counts[b] else init[b]
                for b in range(B)])
            out["outmap"] = outmap_flat
            if self.cfg.emit_frames:
                out["frames_u32"] = frames
            if self.cfg.emit_model_input:
                out["model_input"] = self._model_tensors(frames)
            return out

        # padded layout (mid-GOP windows or a mesh): [B, Cpad] → flat
        outmap_flat = np.where(
            outmap >= 0,
            outmap + (np.arange(B, dtype=np.int32) * cpad)[:, None],
            -1).astype(np.int32)
        out["outmap"] = outmap_flat
        if (self.cfg.mesh is None and not self.cfg.emit_frames
                and self.cfg.emit_model_input):
            # fused: the compacted masked scan emits ONLY model tensors
            carry, model = sp_recon.decode_batch_kmv_model(
                init, self._put(pcc), self._put(mvkc), self._put(valid),
                dtype=self._model_dtype,
                downscale=self.cfg.model_downscale, bpp16=self._bpp16,
                packed=self.cfg.model_packed)
            self._carry = carry
            out["model_input"] = model.reshape((B * cpad,) + model.shape[2:])
            return out
        if self.cfg.mesh is not None:
            frames = self._sharded_kmv_step(pcc, mvkc, valid)
        else:
            frames = sp_recon.decode_batch_kmv(
                init, self._put(pcc), self._put(mvkc), self._put(valid))
        self._carry = frames[:, -1]
        flat = frames.reshape((-1,) + frames.shape[2:])
        if self.cfg.emit_frames:
            out["frames_u32"] = flat
        if self.cfg.emit_model_input:
            out["model_input"] = self._model_tensors(flat)
        return out

    # -- the bc transport ------------------------------------------------------

    def _decode_sp_window_bc(self, chunk, start, decs) -> dict:
        """bc transport host stage: the native decoder fills ONLY data-rect
        plane pixels of a pooled window (no motion fills, no clears, no
        dirty state); the pure-Python oracle branch builds the transport
        with prepare_bc.  The block structure rides bcode/rloc."""
        vi = self.info
        X, Y = vi.width, vi.height
        B, T = len(chunk), self.cfg.window
        nb = ((X + 15) // 16) * ((Y + 15) // 16)
        K = self.cfg.kmv_k
        if getattr(self, "_bcbuf", None) is None:
            self._bcbuf = _pool_acquire(
                ("bc",) + self._buf_key, lambda: dict(
                    plane=np.zeros((B, T, Y, X), dtype=np.uint32),
                    mvk=np.zeros((B, T, K, 2), dtype=np.int32),
                    bcode=np.zeros((B, T, nb), dtype=np.uint8),
                    rloc=np.zeros((B, T, nb, 4), dtype=np.uint8)))
        buf = self._bcbuf
        plane, mvk = buf["plane"], buf["mvk"]
        bcode, rloc = buf["bcode"], buf["rloc"]
        changed = np.zeros((B, T), dtype=bool)
        sig = np.zeros((B, T), dtype=bool)
        if self._sp_native:
            for b, frames in enumerate(chunk):
                dec = decs[b]
                for t, src in enumerate(frames):
                    changed[b, t], sig[b, t] = self._guard(
                        b, lambda: dec.decompress_bc(
                            src, dec.is_key_frame(src), plane[b, t],
                            mvk[b, t], bcode[b, t], rloc[b, t], K=K),
                        default=(False, False))
        else:
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
                (plane[b], bcode[b], rloc[b], mvk[b]) = sp_recon.prepare_bc(
                    bts, mv, rect, payload, K=K)
        return self._bc_route(plane, bcode, rloc, mvk, changed, sig, start)

    def _bc_route(self, plane, bcode, rloc, mvk, changed, sig, start) -> dict:
        """Dispatch an assembled bc window to still-elided scans, the
        sharded mesh step, fused model emission, or the dense batch scan
        (as _kmv_route does)."""
        B = plane.shape[0]
        init = self._carry_init(B)
        if self.cfg.still_elision:
            return self._bc_elided(plane, bcode, rloc, mvk, changed, sig,
                                   init, start)
        if self.cfg.mesh is not None:
            frames = self._sharded_bc_step(plane, bcode, rloc, mvk, changed)
            self._carry = frames[:, -1]
            return self._emit(frames, self._put(sig), start)
        dev = [self._put(a) for a in (plane, bcode, rloc, mvk, changed)]
        if not self.cfg.emit_frames and self.cfg.emit_model_input:
            carry, model = sp_recon.decode_batch_bc_model(
                init, *dev, dtype=self._model_dtype,
                downscale=self.cfg.model_downscale, bpp16=self._bpp16,
                packed=self.cfg.model_packed)
            self._carry = carry
            return {"start_frame": start, "significant": self._put(sig),
                    "model_input": model}
        frames = sp_recon.decode_batch_bc(init, *dev)
        self._carry = frames[:, -1]
        return self._emit(frames, self._put(sig), start)

    def _bc_elided(self, plane, bcode, rloc, mvk, changed, sig, init,
                   start) -> dict:
        """Still-elision for the bc transport: _kmv_elided's output
        contract (flat row stack + outmap), the CONCAT layout when every
        stream's first compacted slot overwrites the whole frame (code 1,
        rect (0, 0, 16, 16) in every block) and there is no mesh, PADDED
        otherwise."""
        B = plane.shape[0]
        vi = self.info
        (plc, bcc, rlc, mvkc), valid, outmap = sp_recon.compact_arrays_batch(
            (plane, bcode, rloc, mvk), changed)
        cpad = plc.shape[1]
        counts = valid.sum(axis=1).astype(np.int64)
        out = {"start_frame": start, "significant": self._put(sig)}
        if cpad == 0:  # all streams all-stills: nothing to decode
            out["outmap"] = outmap
            if self.cfg.emit_frames:
                out["frames_u32"] = torch.zeros(
                    (0, vi.height, vi.width), dtype=torch.int32,
                    device=self.device)
            return out
        full_first = self.cfg.mesh is None and all(
            counts[b] == 0
            or (bool((bcc[b, 0] == 1).all())
                and bool((rlc[b, 0] == (0, 0, 16, 16)).all()))
            for b in range(B))
        self.stats["concat_windows" if full_first else "padded_windows"] += 1
        if full_first:
            offsets = np.zeros(B, dtype=np.int64)
            np.cumsum(counts[:-1], out=offsets[1:])

            def cat(a):
                return self._put(np.concatenate(
                    [a[b, : counts[b]] for b in range(B)]))

            outmap_flat = np.where(
                outmap >= 0, outmap + offsets[:, None], -1).astype(np.int32)
            frames = sp_recon.decode_sequence_bc_compact(
                init[0], cat(plc), cat(bcc), cat(rlc), cat(mvkc))
            ends = offsets + counts  # exclusive
            self._carry = torch.stack([
                frames[int(ends[b]) - 1] if counts[b] else init[b]
                for b in range(B)])
            out["outmap"] = outmap_flat
            if self.cfg.emit_frames:
                out["frames_u32"] = frames
            if self.cfg.emit_model_input:
                out["model_input"] = self._model_tensors(frames)
            return out
        outmap_flat = np.where(
            outmap >= 0,
            outmap + (np.arange(B, dtype=np.int32) * cpad)[:, None],
            -1).astype(np.int32)
        out["outmap"] = outmap_flat
        if self.cfg.mesh is not None:
            frames = self._sharded_bc_step(plc, bcc, rlc, mvkc, valid)
        else:
            frames = sp_recon.decode_batch_bc(
                init, *(self._put(a) for a in (plc, bcc, rlc, mvkc, valid)))
        self._carry = frames[:, -1]
        flat = frames.reshape((-1,) + frames.shape[2:])
        if self.cfg.emit_frames:
            out["frames_u32"] = flat
        if self.cfg.emit_model_input:
            out["model_input"] = self._model_tensors(flat)
        return out

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
            from .batch import DecodeConfig

            vi = self.info
            setattr(self, attr, make(self.cfg.mesh, DecodeConfig(
                height=vi.height, width=vi.width, emit_model_input=False,
                **cfg_kw)))
        return getattr(self, attr)

    def _sharded_kmv_step(self, pc, mvk, changed):
        """kmv windows over the mesh's dp axis: [B, T, ...] → [B, G=1, T,
        ...] rows, each slot scanning its own streams' P-chains."""
        from .batch import make_sp_decode_step_kmv

        if self._gop_group != 1:
            raise ValueError(
                "gop>1 meshes route through the window-grouping path (kmv + "
                "native host stage); this transport shards dp only")
        step = self._sharded_step("_kmv_sharded", make_sp_decode_step_kmv)
        init = self._carry_init(pc.shape[0])
        return step(init[:, None], pc[:, None], mvk[:, None],
                    changed[:, None])[:, 0]

    def _sharded_bc_step(self, plane, bcode, rloc, mvk, changed):
        """bc windows over the mesh's dp axis."""
        from .batch import make_sp_decode_step_bc

        if self._gop_group != 1:
            raise ValueError(
                "gop>1 grouping rides the kmv path; bc shards dp only")
        step = self._sharded_step("_bc_sharded", make_sp_decode_step_bc)
        init = self._carry_init(plane.shape[0])
        return step(init[:, None], plane[:, None], bcode[:, None],
                    rloc[:, None], mvk[:, None], changed[:, None])[:, 0]

    def _decode_sp_window_group(self, chunks, starts) -> list[dict]:
        """Decode G keyframe-led windows in ONE sharded [B, G, T] dispatch
        over the (dp, gop) mesh.  Every window after the first must start
        with a keyframe (or be stream-end padding): keyframes make windows
        independent decode chains, so no slot waits on another.  → one
        output dict per real window."""
        from .batch import make_sp_decode_step_bc, make_sp_decode_step_kmv

        vi = self.info
        X, Y = vi.width, vi.height
        G = self._gop_group
        B, T = len(chunks[0]), self.cfg.window
        K = self.cfg.kmv_k
        decs = self._sp_decoders()
        if self.cfg.still_elision:
            raise ValueError(
                "still_elision with a gop>1 mesh is not supported yet")
        use_bc = self.cfg.sp_device_path == "bc"
        nb = ((X + 15) // 16) * ((Y + 15) // 16)
        if use_bc:
            if getattr(self, "_bcgbuf", None) is None:
                self._bcgbuf = _pool_acquire(
                    ("bcg", G) + self._buf_key, lambda: dict(
                        pc=np.zeros((B, G, T, Y, X), dtype=np.uint32),
                        mvk=np.zeros((B, G, T, K, 2), dtype=np.int32),
                        bcode=np.zeros((B, G, T, nb), dtype=np.uint8),
                        rloc=np.zeros((B, G, T, nb, 4), dtype=np.uint8)))
            buf = self._bcgbuf
        else:
            if getattr(self, "_kmvgbuf", None) is None:
                self._kmvgbuf = _pool_acquire(
                    ("kmvg", G) + self._buf_key, lambda: dict(
                        pc=np.zeros((B, G, T, Y, X), dtype=np.uint32),
                        mvk=np.zeros((B, G, T, K, 2), dtype=np.int32),
                        dirty=np.zeros((B, G, T, nb + 1), dtype=np.int32)))
            buf = self._kmvgbuf
        pc, mvk = buf["pc"], buf["mvk"]
        changed = np.zeros((B, G, T), dtype=bool)
        sig = np.zeros((B, G, T), dtype=bool)
        for g, chunk in enumerate(chunks):
            for b, frames in enumerate(chunk):
                dec = decs[b]
                if g > 0 and frames[0] and not dec.is_key_frame(frames[0]):
                    raise ValueError(
                        "gop>1 mesh requires keyframe-led windows "
                        f"(window @{starts[g]} stream {b} starts mid-GOP); "
                        "align IngestConfig.window with the keyframe cadence")
                for t, src in enumerate(frames):
                    if use_bc:
                        step = lambda: dec.decompress_bc(
                            src, dec.is_key_frame(src), pc[b, g, t],
                            mvk[b, g, t], buf["bcode"][b, g, t],
                            buf["rloc"][b, g, t], K=K)
                    else:
                        step = lambda: dec.decompress_kmv(
                            src, dec.is_key_frame(src), pc[b, g, t],
                            mvk[b, g, t], K=K, dirty=buf["dirty"][b, g, t])
                    changed[b, g, t], sig[b, g, t] = self._guard(
                        b, step, default=(False, False))
        gstep = (self._sharded_step("_bcg_sharded", make_sp_decode_step_bc)
                 if use_bc else
                 self._sharded_step("_kmvg_sharded", make_sp_decode_step_kmv))
        # g=0 continues the previous group's carry; g>0 windows are
        # keyframe-led, so zeros are exact (the I-frame paints every pixel)
        rows = B if self._carry is None else self._carry.shape[0]
        init = torch.zeros((rows, G, Y, X), dtype=torch.int32,
                           device=self.device)
        if self._carry is not None:
            init[:, 0] = self._carry
        if use_bc:
            frames = gstep(init, pc, buf["bcode"], buf["rloc"], mvk, changed)
        else:
            frames = gstep(init, pc, mvk, changed)
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
        if getattr(self, "_spbuf", None) is None:
            self._spbuf = _pool_acquire(("sp",) + self._buf_key, lambda: dict(
                bts=np.zeros((B, T, nb), dtype=np.int32),
                mv=np.zeros((B, T, nb, 2), dtype=np.int32),
                rect=np.zeros((B, T, nb, 4), dtype=np.int32),
                payload=np.zeros((B, T, Y, X), dtype=np.uint32),
            ))
        buf = self._spbuf
        bts, mv, rect, payload = (buf["bts"], buf["mv"], buf["rect"],
                                  buf["payload"])
        changed = np.zeros((B, T), dtype=bool)
        sig = np.zeros((B, T), dtype=bool)
        is_key0 = np.zeros(B, dtype=bool)
        frozen = set(self.quarantined)  # before this window
        t_fail = {}  # stream → the step whose decode failed in this window
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

        preps = [prep(b) for b in range(B)]
        m_max = max(1, max(p[2].shape[1] for p in preps))
        m_pad = 1 << (m_max - 1).bit_length()

        def padM(tiles, tyx):
            # prepare_kmv_sparse guarantees M >= 1 with final-content pad
            # tiles, so repeating column 0 is always a correct no-op rewrite
            reps = m_pad - tiles.shape[1]
            if reps == 0:
                return tiles, tyx
            return (np.concatenate([tiles, np.repeat(tiles[:, :1], reps, 1)],
                                   1),
                    np.concatenate([tyx, np.repeat(tyx[:, :1], reps, 1)], 1))

        bc = np.stack([p[0] for p in preps])
        mvk = np.stack([p[1] for p in preps])
        padded = [padM(p[2], p[3]) for p in preps]
        tiles = np.stack([q[0] for q in padded])
        tyx = np.stack([q[1] for q in padded])
        init = (self._put(payload[:, 0] & np.uint32(0x00FFFFFF)) if skip0
                else self._carry_init(B))
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
        if getattr(self, "_sparsebuf", None) is None:
            self._sparsebuf = _pool_acquire(
                ("sparse",) + self._buf_key, lambda: dict(
                    bc=np.zeros((B, T, nb), dtype=np.uint8),
                    mvk=np.zeros((B, T, K, 2), dtype=np.int32),
                    tiles=np.zeros((B, T, nb, 16, 16), dtype=np.uint32),
                    tyx=np.zeros((B, T, nb, 2), dtype=np.int32),
                    init=np.zeros((B, Y, X), dtype=np.uint32),
                ))
        buf = self._sparsebuf
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

        if B > 1:
            # the native calls release the GIL; each thread owns disjoint
            # buffer rows
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
        if self.cfg.sparse_lane_payload and flat.shape[0] > 1:
            # tile pixels cross the link rANS-coded and are lane-decoded on
            # the device
            from ..kernels import lane_transport as _lt

            pack = _lt.encode_tiles(flat & np.uint32(0x00FFFFFF))
            flat_dev = _lt.decode_tiles_device(pack, self.device)
        else:
            flat_dev = self._put(flat)
        frames = sp_recon.decode_batch_kmv_sparse_ragged(
            init, self._put(bc[:, t0:]), self._put(mvk[:, t0:]), flat_dev,
            self._put(tile_idx), self._put(tyx[:, t0:, :m_pad]),
            self._put(changed[:, t0:]))
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
        pal = (palette_to_u32(vi.palette) if vi.codec == CodecType.MSVC8
               else None)
        B, T = len(chunk), self.cfg.window
        nb = (X >> 2) * (Y >> 2)
        bt = np.zeros((B, T, nb), dtype=np.uint8)
        sel = np.zeros((B, T, nb, 16), dtype=np.uint8)
        col = np.zeros((B, T, nb, 8), dtype=np.uint32)
        chg = np.zeros((B, T), dtype=bool)
        from .. import native as _native

        parse = (_native.native_msv1_parse if _native.available()
                 else parse_commands)
        for b, frames in enumerate(chunk):
            for t, src in enumerate(frames):
                # a malformed MSV1 stream quarantines its slot (frozen at
                # the last good frame) instead of failing the batch
                got = self._guard(b, lambda: parse(src, X, Y, pal=pal))
                if got is None:
                    continue
                bt[b, t], sel[b, t], col[b, t], chg[b, t] = got
        init = self._carry_init(B)
        il = self.cfg.insignificant_lines
        sel = msv1_paint.sel_to_plane(sel, Y, X)  # the device's plane order
        if self.cfg.mesh is not None:
            frames, signif = self._sharded_msv1_window(init, start, bt, sel,
                                                       col, chg)
        else:
            # as the reference: valid when the window is not the stream's
            # first
            valid = torch.full((B,), start > 0, dtype=torch.bool,
                               device=self.device)
            frames, signif = msv1_paint.decode_batch(
                init, valid, self._put(bt), self._put(sel), self._put(col),
                self._put(chg), (il + 3) >> 2, il, X // 4)
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
            want = max(0, int(np.searchsorted(bases, tt0, side="right")) - 1)
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
            # greedy group: extend while the next window is carry-free
            G = 1
            while (G < gop_size and wi + G < wi_end
                   and all_restart(wi + G)):
                G += 1
            ts = Ts[wi: wi + G]
            total_real = sum(ts)
            h = self._lane_group(wi, ts, raw)
            # every entry starts from its stream's carry (restart entries
            # ignore it; absent entries pass it through)
            init = self._carry_init(B)
            if G > 1:
                init = init.repeat_interleave(G, dim=0)
            # rans mode: window-leading keyframes ride as raw init planes
            # (the scan's frame 0 is an all-copy passthrough): those
            # entries start from their plane, on the device
            if h["init"] is not None:
                mask = np.array([p is not None for p in h["init"]])
                planes = np.stack([np.zeros((Y, X), np.uint32) if p is None
                                   else p for p in h["init"]])
                init = torch.where(
                    self._put(self._local_rows(mask, B, G))[:, None, None],
                    self._put(self._local_rows(planes, B, G)), init)
            btype, rect, mvk, row_idx = (h[k] for k in (
                "btype", "rect", "mvk", "row_idx"))
            changed = h["changed"]
            # still-elision: stills never enter the lane scan (the flat row
            # stack + outmap contract of _kmv_elided; -1 = the window's
            # carry-in frame)
            outmap = None
            if self.cfg.still_elision:
                (btype, rect, mvk, row_idx), changed, outmap = \
                    sp_recon.compact_arrays_batch(
                        (btype, rect, mvk, row_idx), changed)
                cpad = btype.shape[1]
                om = np.where(
                    outmap >= 0,
                    outmap + (np.arange(B * G, dtype=np.int32)
                              * cpad)[:, None],
                    -1).astype(np.int32)
                # ragged windows: keep only each window's real frames
                outmap = np.stack([
                    np.concatenate([om[b * G + g, : ts[g]]
                                    for g in range(G)])
                    for b in range(B)])
            if changed.shape[1] == 0:  # all streams all-stills
                out = {"start_frame": int(bases[wi]),
                       "significant": self._put(h["sig"]),
                       "outmap": outmap,
                       "frames_u32": torch.zeros((0, Y, X), dtype=torch.int32,
                                                 device=self.device)}
            else:
                cmds = (btype, rect, mvk, h["row_table"], row_idx, changed)
                data = ((h["payload"],) if raw else
                        tuple(h[k] for k in ("refills", "states", "freq")))
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
                        init, *map(self._put, data + cmds), h["u_pad"])
                # a stream's carry: its last entry's last frame
                self._carry = frames[G - 1:: G, -1]
                out = {"start_frame": int(bases[wi]),
                       "significant": self._put(h["sig"])}
                if outmap is not None:
                    out["outmap"] = outmap
                    flat = frames.reshape((-1,) + frames.shape[2:])
                    if self.cfg.emit_frames:
                        out["frames_u32"] = flat
                    if self.cfg.emit_model_input:
                        out["model_input"] = self._model_tensors(flat)
                else:
                    # [B*G, Tpad, ...] → [B, G*T, ...]: stream-major entries
                    # read as one window; ragged (keyframe-snapped) windows
                    # keep only their real frames
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
        if self.cfg.model_packed:
            if self.cfg.model_downscale != 2:
                raise ValueError("model_packed requires model_downscale == 2")
            return ds2_packed_output(frames)
        return to_model_input(
            frames, dtype=self._model_dtype,
            downscale=self.cfg.model_downscale, bpp16=self._bpp16)

    def _emit(self, frames, signif, start) -> dict:
        out = {"start_frame": start, "frames_u32": frames,
               "significant": signif}
        if self.cfg.emit_model_input:
            out["model_input"] = self._model_tensors(frames)
        return out

"""Batched video ingestion on torch: AVI sources → model-input tensors.

Counterpart of jsplayer_tpu/pipeline/ingest.py for its main path, the
ScreenPressor kmv transport: N AVI streams are demuxed on the host and
entropy-decoded straight into the kmv transport (the native C++ decoder,
or the pure-Python oracle where the native library is missing), then
reconstructed on the device in windows — optionally with still-elision
(CONCAT and PADDED layouts) and fused into model tensors.  Decoded pixels
never round-trip to the host between windows; failures quarantine per
stream.

The window dicts have the reference's keys, shapes and meaning.  u32
planes (``frames_u32``) are int32 tensors holding the u32 bits (see
device.py); ``outmap`` stays a numpy array as in the reference.

What the reference does beyond this path raises NotImplementedError
naming its ROADMAP.md queue item: MSVideo1, other sp_device_path values,
a mesh, lane containers.

StreamReader, _StreamingFrames, _trim_window, _oracle_decode_step and the
host-buffer pool are copies of the reference's: its module imports jax at
the top, which this package never does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from jsplayer_tpu.core.loader import DataLoaderAVISeq
from jsplayer_tpu.core.source import ByteSource
from jsplayer_tpu.core.types import CodecType, VideoInfo

from ..device import resolve_device, to_device, torch_to_u32
from ..kernels import sp_recon
from ..kernels.rgb_convert import ds2_packed_output, to_model_input

_LANE_MAGIC = b"JLV1"  # codecs/lane_format.py _MAGIC (not imported: jax)

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
    `device`.  Only the SP kmv path is ported: sp_device_path must be
    "kmv" and mesh None (checked by VideoIngestPipeline)."""
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
    sp_device_path: str = "kmv"
    kmv_k: int = 2
    sparse_lane_payload: bool = False
    # True: unchanged frames never enter the device scan; the dict gains
    # "outmap" (see the reference's field comment for the layouts)
    still_elision: bool = False
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


class _StreamingFrames:
    """Minimal sequence facade over a streaming reader (len = frames parsed
    so far) — keeps non-streaming call sites (`len(r.frames)`) working."""

    def __init__(self, reader: StreamReader):
        self._r = reader

    def __len__(self) -> int:
        return self._r.loader.loaded_frames_end()


class VideoIngestPipeline:
    """Iterate model-tensor windows over a batch of same-geometry
    ScreenPressor streams (kmv transport)."""

    def __init__(self, sources: Sequence[ByteSource],
                 config: Optional[IngestConfig] = None):
        self.cfg = config or IngestConfig()
        self.device = resolve_device(self.cfg.device)
        if self.cfg.sp_device_path != "kmv":
            raise NotImplementedError(
                f"sp_device_path={self.cfg.sp_device_path!r} is not ported "
                f"yet (ROADMAP.md queue 1: bc item 6, lane item 7, "
                f"kmv_sparse item 8, general/pallas item 9)")
        if self.cfg.mesh is not None:
            raise NotImplementedError(
                "mesh sharding is not ported yet (ROADMAP.md queue 1 "
                "item 11)")
        if any(s.read_range(0, 3)[:4] == _LANE_MAGIC for s in sources):
            raise NotImplementedError(
                "lane containers are not ported yet (ROADMAP.md queue 1 "
                "item 7)")
        self.readers = [StreamReader(s, streaming=self.cfg.streaming)
                        for s in sources]
        info0 = self.readers[0].info
        for r in self.readers:
            assert (r.info.width, r.info.height, r.info.codec) == (
                info0.width, info0.height, info0.codec
            ), "streams in a batch must share geometry and codec"
        if info0.codec != CodecType.SCREENPRESSOR:
            raise NotImplementedError(
                f"{info0.codec.value} streams are not ported yet "
                f"(ROADMAP.md queue 1 item 10, MSV1)")
        self.info = info0
        # streaming mode: a lower bound that grows as windows demux
        self.nframes = max(len(r.frames) for r in self.readers)
        # 16bpp ScreenPressor decodes to 5-bit channels (scaled <<3 for
        # the model, Manager.hx:363-370)
        self._bpp16 = info0.bpp == 16
        self._model_dtype = getattr(torch, self.cfg.model_dtype)
        #: per-stream AudioTrack (MP3 sections, PTS, time_loaded watermark)
        self.audio_tracks = [r.audio_track for r in self.readers]
        # per-stream failure quarantine: a malformed frame freezes that
        # stream at its last good frame; other batch slots continue
        self.quarantined: set[int] = set()
        self.quarantine_errors: list[tuple[int, str]] = []
        #: which elision layout each window used (CONCAT keyframe-led,
        #: PADDED mid-GOP)
        self.stats = {"concat_windows": 0, "padded_windows": 0}
        self._carry: Optional[torch.Tensor] = None

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
        if self.cfg.still_elision and not self.cfg.streaming:
            # keyframe-aligned scheduling: a window that starts mid-GOP
            # falls off the CONCAT elision layout onto the padded scans, so
            # snap each boundary DOWN to the latest keyframe within reach;
            # chunks pad with no-change frames and emissions are trimmed
            keys = self._keyframe_positions()
            if len(keys) > 1:
                from jsplayer_tpu.pipeline.gop import snap_window_starts

                starts = snap_window_starts(keys, self.nframes,
                                            self.cfg.window)
        return starts

    def _keyframe_prober(self):
        from jsplayer_tpu.codecs.screenpressor import ScreenPressor

        vi = self.info
        return ScreenPressor(vi.width, vi.height, vi.bpp)

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
                    out = self._decode_sp_window(chunk, start)
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
                out = self._decode_sp_window(chunk, start)
                if end - start < W:
                    out = _trim_window(out, end - start)
                if pending is not None:
                    yield pending
                pending = out
            if pending is not None:
                yield pending
        finally:
            self._release_buffers()

    def _release_buffers(self):
        # uploads are blocking copies (device.to_device), so no device work
        # still reads these host pages
        for attr, key in (("_spbuf", ("sp",)), ("_kmvbuf", ("kmv",))):
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
            from jsplayer_tpu import native as _native

            self._spdecs = []
            self._sp_native = _native.available()
            for _ in self.readers:
                if self._sp_native:
                    d = _native.NativeScreenPressor(vi.width, vi.height, vi.bpp)
                else:
                    from jsplayer_tpu.codecs.screenpressor import ScreenPressor

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
        if self._sp_native:
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
        # pure-Python host stage: oracle decode with command capture, then
        # the numpy kmv prep; window buffers are reused across iterations
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

    def _kmv_route(self, pc, mvk, changed, sig, start) -> dict:
        """Dispatch an assembled kmv window (pc [B,T,Y,X], mvk [B,T,K,2],
        changed/sig [B,T]) to still-elided scans, fused model emission, or
        the dense batch scan.  Shared by both host branches."""
        B = pc.shape[0]
        init = self._carry_init(B)
        if self.cfg.still_elision and B > 1:
            return self._kmv_elided(pc, mvk, changed, sig, init, start)
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
          * PADDED — otherwise, the per-stream masked scans of bucketed
            length Cpad run as one batched scan and the [B, Cpad] result is
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

        full_first = all(
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

        # padded layout (mid-GOP windows): [B, Cpad] → flat
        outmap_flat = np.where(
            outmap >= 0,
            outmap + (np.arange(B, dtype=np.int32) * cpad)[:, None],
            -1).astype(np.int32)
        out["outmap"] = outmap_flat
        if not self.cfg.emit_frames and self.cfg.emit_model_input:
            # fused: the compacted masked scan emits ONLY model tensors
            carry, model = sp_recon.decode_batch_kmv_model(
                init, self._put(pcc), self._put(mvkc), self._put(valid),
                dtype=self._model_dtype,
                downscale=self.cfg.model_downscale, bpp16=self._bpp16,
                packed=self.cfg.model_packed)
            self._carry = carry
            out["model_input"] = model.reshape((B * cpad,) + model.shape[2:])
            return out
        frames = sp_recon.decode_batch_kmv(
            init, self._put(pcc), self._put(mvkc), self._put(valid))
        self._carry = frames[:, -1]
        flat = frames.reshape((B * cpad,) + frames.shape[2:])
        if self.cfg.emit_frames:
            out["frames_u32"] = flat
        if self.cfg.emit_model_input:
            out["model_input"] = self._model_tensors(flat)
        return out

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

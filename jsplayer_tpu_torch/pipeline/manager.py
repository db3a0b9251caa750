"""Playback orchestrator: decoder + loader ownership, buffer ring, decode-
ahead worker, seek, skip-stills.

Parity surface: Manager (Manager.hx:38-579).  The reference drives ``worker``
from a 1 ms timer (Manager.hx:139-141) because JS has no threads; here the
host application (player.py) steps the worker explicitly — same cooperative
unit of work, pull-driven.  Everything else keeps the reference's shape:

  * ring of N decoded-frame buffers with states trash/has_frames(first,last)
    (BufferState, Manager.hx:27-30; buffers allocated in video_info_cb,
    :114-119); identical consecutive frames extend a buffer's range instead
    of copying (update_bufs, :568-578) — the still-screen optimization;
  * get_decompressed_frame scans the ring, resets the decode cursor to the
    nearest keyframe on seek and trashes all buffers (:216-260);
  * worker: pick a free buffer (evicting the oldest fully-behind one,
    get_free_buffer :424-443), fetch the next frame, DecompressI/P, update
    ring; parse audio when no buffer is free (:454-539);
  * skip-stills with a compute budget (THINK_LIMIT, :287-317);
  * I-frame significant-change fallback via byte/pixel compare
    (frames_differ_significantly, :392-421).

Display conversion (fill_bitmap_data, :325-390) lives in
kernels/rgb_convert.py for the device path; ``get_rgba`` here provides the
host-side equivalent for UI consumers.
"""

from __future__ import annotations

import enum
import math
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from ..codecs.base import DecoderState, VideoCodec
from ..codecs.msvideo1 import MSVideo1_8bit, MSVideo1_16bit
from ..codecs.screenpressor import ScreenPressor
from ..core.loader import DataLoader
from ..core.types import CodecType, FrameStatus, VideoInfo
from ..utils.logging import LOG

INSIGNIFICANT_LINES = 36  # Manager.hx:61 (bottom 36 on screen; frames are
                          # stored bottom-up, Main.hx:318)
THINK_LIMIT = 0.05  # Manager.hx:287


class FrameResult(enum.Enum):
    DECOMPRESSED = "decompressed"
    SOON = "soon"  # downloaded, decompressing
    NOTSOON = "notsoon"  # not downloaded yet


@dataclass
class BufferState:
    """trash or has_frames(first,last) (Manager.hx:27-30)."""

    trash: bool = True
    first: int = -1
    last: int = -1


def make_decoder(vi: VideoInfo, prefer_native: bool = True) -> VideoCodec:
    # Manager.video_info_cb codec select (Manager.hx:105-111); the native C++
    # decoder is used when built (bit-exact twin, ~10x faster host decode)
    if vi.codec == CodecType.SCREENPRESSOR:
        if prefer_native:
            from .. import native as _native

            if _native.available():
                from ..codecs.native_sp import NativeScreenPressorCodec

                return NativeScreenPressorCodec(vi.width, vi.height, vi.bpp)
        return ScreenPressor(vi.width, vi.height, vi.bpp)
    if vi.codec in (CodecType.MSVC16, CodecType.MSVC8):
        if prefer_native:
            from .. import native as _native

            if _native.available():
                from ..codecs.native_sp import NativeMsv1Codec

                return NativeMsv1Codec(
                    vi.width, vi.height,
                    vi.palette if vi.codec == CodecType.MSVC8 else None)
        if vi.codec == CodecType.MSVC16:
            return MSVideo1_16bit(vi.width, vi.height)
        return MSVideo1_8bit(vi.width, vi.height, vi.palette or b"")
    raise ValueError(vi.codec)


class Manager:
    def __init__(self, loader: DataLoader, num_buffers: int = 8):
        # N=8 as set by the player (Main.hx:148)
        self.loader = loader
        self.num_buffers = num_buffers
        self.bufs = [BufferState() for _ in range(num_buffers)]
        self.buffers: list[np.ndarray] = []
        self.decoder: Optional[VideoCodec] = None
        self.video_info: Optional[VideoInfo] = None
        self.fps = 15.0
        self.nframes = 0
        self.frame_of_interest = 0
        self.next_frame_to_decode = 0
        self.last_frame_drawn = -1
        self.shown_time = 0.0
        self.seek_cb: Optional[Callable[[], None]] = None
        self._seek_t0: Optional[float] = None
        self.last_seek_ms: Optional[float] = None  # Main.hx:1220-1226 probe
        self.last_iframe_decode_ms: Optional[float] = None  # ScreenPressor.hx:127
        self.delayed_fill: Optional[Callable[[int, float], None]] = None
        self.convert_from_rgb15 = False
        self.loading_pause = False
        self._on_open_cb: Optional[Callable[[VideoInfo], None]] = None
        self._last_filled_buffer: Optional[int] = None

    # -- lifecycle -------------------------------------------------------------

    def open(self, source, on_open: Optional[Callable[[VideoInfo], None]] = None
             ) -> None:
        # Manager.Open (Manager.hx:97-101)
        self._on_open_cb = on_open
        self.loader.open(source, self._video_info_cb)
        # pump until the header yields video info (the reference's XHR events
        # do this implicitly)
        while self.video_info is None and self.loader.pump():
            pass

    def _video_info_cb(self, vi: VideoInfo) -> None:
        # Manager.video_info_cb (Manager.hx:103-142)
        self.video_info = vi
        # a loader that owns non-AVI stream state (LaneDataLoader's parsed
        # container) supplies its own decoder; AVI loaders use the codec
        # registry (Manager.hx:105-111)
        mk = getattr(self.loader, "make_decoder", None)
        self.decoder = mk(vi) if mk is not None else make_decoder(vi)
        npix = vi.width * vi.height
        self.buffers = [np.zeros(npix, dtype=np.uint32)
                        for _ in range(self.num_buffers + 1)]
        # 16bpp SP pixels (and lane containers transcoded from them) are
        # RGB15 needing the <<3 display expansion; MSV1-sourced lanes are
        # already RGB888 (transcode_to_lane records bpp=24 for those)
        self.convert_from_rgb15 = (vi.bpp == 16 and vi.codec in (
            CodecType.SCREENPRESSOR, CodecType.LANE))
        self.decoder.preinit(INSIGNIFICANT_LINES)
        self.fps = vi.fps
        self.nframes = vi.nframes
        self.next_frame_to_decode = 0
        self.loader.decoder = self.decoder
        if self._on_open_cb is not None:
            self._on_open_cb(vi)

    def stop_and_clean(self) -> None:
        # Manager.StopAndClean (Manager.hx:81-95)
        if self.loader is not None:
            self.loader.stop_and_clean()
        if self.decoder is not None:
            self.decoder.stop_and_clean()
        self.buffers = []
        self.bufs = []
        self.delayed_fill = None
        self.seek_cb = None

    # -- time mapping (Manager.hx:144-214) -------------------------------------

    def time_to_fraction(self, t: float) -> float:
        if self.nframes <= 0 or self.fps == 0:
            return 0.0
        return t / (self.nframes / self.fps)

    def fraction_to_time(self, prc: float) -> float:
        if self.nframes <= 0 or self.fps == 0:
            return 0.0
        return prc * (self.nframes / self.fps)

    def loaded_fraction_end(self) -> float:
        if self.nframes <= 0:
            return 0.0
        return self.loader.loaded_frames_end() / self.nframes

    def loaded_fraction_start(self) -> float:
        if self.nframes <= 0:
            return 0.0
        return self.loader.loaded_frames_start() / self.nframes

    def total_time(self) -> float:
        return self.nframes / self.fps if self.fps else 0.0

    def frame_time(self, frm: int) -> float:
        return frm / self.fps if self.fps else 0.0

    def next_frame_time(self) -> float:
        return (self.last_frame_drawn + 1) / self.fps + 0.001 if self.fps else 0.0

    def prev_frame_time(self) -> float:
        if self.fps == 0 or self.last_frame_drawn <= 0:
            return 0.0
        return (self.last_frame_drawn - 1) / self.fps + 0.001

    def prev_key_time(self) -> float:
        key = self.loader.get_nearest_keyframe(self.last_frame_drawn - 1)
        return self.frame_time(key) + 0.001

    def next_key_time(self) -> float:
        key = self.loader.get_next_keyframe(self.last_frame_drawn + 1)
        return self.frame_time(key) + 0.001

    def loaded_audio_time(self) -> float:
        return self.loader.audio_time_loaded(self.fps) if self.fps else 0.0

    def worker_pos(self) -> float:
        # Manager.WorkerPos (Manager.hx:281-285)
        return self.next_frame_to_decode / self.nframes if self.nframes > 0 else 0.0

    # -- presentation ----------------------------------------------------------

    def get_decompressed_frame(self, t: float, playing: bool) -> FrameResult:
        # Manager.GetDecompressedFrame (Manager.hx:216-260).  Sanitize the
        # time: page-supplied seeks reach here unclamped, and a negative
        # frame_of_interest would python-negative-index the loader's frame
        # list (aliasing tail frames — fuzz-found, seed 271828) while NaN
        # dies in int().
        if math.isnan(t) or t < 0.0:
            t = 0.0
        foi = int(min(t * self.fps, 2 ** 62))
        if self.nframes > 0:
            foi = min(foi, self.nframes - 1)
        self.frame_of_interest = foi
        self.loader.notify_player_position(self.frame_of_interest)

        for nb, b in enumerate(self.bufs):
            if not b.trash and b.first <= self.frame_of_interest <= b.last:
                self.shown_time = t
                self._fill(nb)
                self.delayed_fill = None
                return FrameResult.DECOMPRESSED

        f = self.loader.get_frame(self.frame_of_interest)
        if f.status == FrameStatus.NOT_READY:
            # not demuxed yet: register the deferred fill so the decode-
            # ahead worker presents the frame when its data arrives (the
            # reference re-polls from its always-running timers; a paused
            # seek here would otherwise never draw the target)
            self.delayed_fill = self._delayed_fill
            return FrameResult.NOTSOON
        if f.status == FrameStatus.READY:
            key_idx = self.loader.get_nearest_keyframe(self.frame_of_interest)
            if (self.next_frame_to_decode < key_idx
                    or self.next_frame_to_decode > self.frame_of_interest):
                # seek (Manager.hx:244-249)
                self.next_frame_to_decode = key_idx
                for b in self.bufs:
                    b.trash = True
            self.delayed_fill = self._delayed_fill
            return FrameResult.SOON
        # LOADING (Manager.hx:252-257): on completion the reference RE-CALLS
        # GetDecompressedFrame — that re-entry is what resets the decode
        # cursor to the seek target's keyframe once the data is in
        self.loading_pause = True

        def resume() -> None:
            self.get_decompressed_frame(t, playing)
            self.loading_pause = False

        self.loader.set_on_load_complete(resume)
        self.delayed_fill = self._delayed_fill
        return FrameResult.NOTSOON if playing else FrameResult.SOON

    def _delayed_fill(self, nb: int, t: float) -> None:
        self.shown_time = t
        self._fill(nb)

    def _fill(self, nbuf: int) -> None:
        # Track the source buffer BEFORE the "already drawn" short-circuit
        # (Manager.fill_bitmap_data:327): the reference draws into a
        # persistent shared bitmap so skipping is safe there, but get_rgba
        # here converts lazily from _last_filled_buffer — after a seek away
        # and back to the same frame (old buffer reused for other frames),
        # a stale pointer would show the wrong image.
        self._last_filled_buffer = nbuf
        if self.frame_of_interest == self.last_frame_drawn:
            return
        self.last_frame_drawn = self.frame_of_interest

    def get_rgba(self) -> Optional[np.ndarray]:
        """Host-side display conversion of the last shown buffer
        (fill_bitmap_data, Manager.hx:360-387): → u32 ARGB [H*W]."""
        if self._last_filled_buffer is None:
            return None
        src = self.buffers[self._last_filled_buffer]
        if self.convert_from_rgb15:
            # NOTE (reference-parity quirk): 16bpp FLAT frames are stored
            # with channels already <<3-expanded in (r,g,b) order
            # (ScreenPressor.hx:136-140) yet the reference still applies
            # this same <<3 at display (Manager.hx:369), double-expanding
            # them; coded frames store raw 5-bit channels.  Kept bit-exact
            # rather than silently diverging.
            return (0xFF000000 | (src << 3)).astype(np.uint32)
        return (0xFF000000 | ((src & 0xFF) << 16) | (src & 0xFF00)
                | ((src >> 16) & 0xFF)).astype(np.uint32)

    # -- seek ------------------------------------------------------------------

    def seek_to(self, t: float, seek_done: Callable[[], None]) -> bool:
        # Manager.SeekTo (Manager.hx:262-279); the wall-clock pair around it
        # mirrors the reference's seek-latency probe (tseek0 at seek_start,
        # Main.hx:1213-1214; "seek done in t=…" log, Main.hx:1220-1226)
        self._seek_t0 = time.monotonic()
        res = self.get_decompressed_frame(t, playing=False)
        if res in (FrameResult.DECOMPRESSED, FrameResult.NOTSOON):
            if res == FrameResult.DECOMPRESSED:
                self._seek_finished()
            else:  # target not presentable (data still loading): the seek
                self._seek_t0 = None  # never completed — don't log ~0 ms
            seek_done()
            return False
        self.seek_cb = seek_done
        return True

    def _seek_finished(self) -> None:
        if self._seek_t0 is None:
            return
        t1 = time.monotonic()
        self.last_seek_ms = (t1 - self._seek_t0) * 1e3
        LOG.fast_log("seek done", self._seek_t0, t1)
        self._seek_t0 = None

    # -- skip stills -----------------------------------------------------------

    def skip_stills(self, first_call: bool) -> Optional[float]:
        # Manager.SkipStills (Manager.hx:289-317)
        if first_call:
            self.frame_of_interest += 1
        t0 = time.monotonic()
        while True:
            kind, pos = self.loader.find_possible_change(self.frame_of_interest)
            if kind == "change":
                self.frame_of_interest = pos
                return self.frame_of_interest / self.fps
            self.frame_of_interest = pos
            if time.monotonic() - t0 > THINK_LIMIT:
                # the reference checks the budget only inside the decode
                # loop below; guard the outer loop too so an 'unknown'
                # verdict that decoding cannot settle yields instead of
                # spinning at 100% CPU
                return None
            while self.next_frame_to_decode <= self.frame_of_interest:
                before = self.next_frame_to_decode
                for _ in range(10):
                    self.worker(external=False)
                if time.monotonic() - t0 > THINK_LIMIT:
                    return None
                if (self.next_frame_to_decode == before
                        and not self._worker_can_progress()):
                    # no decode progress and no data coming: bail rather
                    # than spin (the reference can rely on more XHR events)
                    return None

    def _worker_can_progress(self) -> bool:
        f = self.loader.get_frame_not_loading(self.next_frame_to_decode)
        return f.status == FrameStatus.READY or self.loader.pump()

    # -- decode-ahead worker ---------------------------------------------------

    def _get_free_buffer(self, prev_idx: int) -> int:
        # Manager.get_free_buffer (Manager.hx:424-443)
        oldest_index = -1
        oldest_frame = 10 ** 8
        for i, b in enumerate(self.bufs):
            if i == prev_idx:
                continue
            if b.trash:
                return i
            if b.last < self.frame_of_interest and b.first < oldest_frame:
                oldest_frame = b.first
                oldest_index = i
        if oldest_index >= 0:
            self.bufs[oldest_index].trash = True
            return oldest_index
        return -1

    def worker(self, external: bool = True) -> None:
        # Manager.worker (Manager.hx:454-539).  `external` mirrors the
        # reference's `e != null` timer-event check (Manager.hx:545-546):
        # only an externally-driven worker step may start a seek burst —
        # worker calls made FROM _force_work/skip_stills pass False, else
        # worker→_force_work→worker recurses ~2 stack frames per decoded
        # frame and a long-GOP seek RecursionErrors.
        if self.decoder is None:
            return
        if self.decoder.state() == DecoderState.IN_PROGRESS:
            self.decoder.continue_i()
            return
        if self.loading_pause:
            self.loader.pump()  # make progress toward resume
            return

        prev_frame = self.decoder.previous_frame()
        prev_idx = -1
        for i, buf in enumerate(self.buffers):
            if prev_frame is buf:
                prev_idx = i
                break
        free_idx = self._get_free_buffer(prev_idx)
        if free_idx < 0:
            self.loader.parse_sound()  # audio piggyback (Manager.hx:478-481)
            return

        info = self.loader.get_frame(self.next_frame_to_decode)
        if info.status == FrameStatus.NOT_READY:
            self.loader.pump()  # wait for data ≙ XHR progress events
            return
        if info.status == FrameStatus.LOADING:
            self.loading_pause = True
            self.loader.set_on_load_complete(self._resume_loading)
            self.loader.pump()
            return

        frm = info.frame
        LOG.count("frames_decoded")
        new_frame = self.buffers[free_idx]
        if frm.key:
            # per-keyframe decode-time probe ≙ the reference's DecompressI
            # wall-clock pair (ScreenPressor.hx:127,287-288)
            _t0 = time.monotonic()
            state = self.decoder.decompress_i(frm.data, new_frame)
            _t1 = time.monotonic()
            self.last_iframe_decode_ms = (_t1 - _t0) * 1e3
            LOG.fast_log("decompress_i", _t0, _t1)
            if state == DecoderState.ZERO:
                self._update_bufs(free_idx, self.next_frame_to_decode, True)
                if frm.significant_changes is None:
                    frm.significant_changes = self._frames_differ(
                        new_frame, prev_frame, frm)
                self.next_frame_to_decode += 1
            # ERROR: log-and-continue (handle_decode_status, Manager.hx:445-452
            # only traces — the reference retries the frame forever; we skip
            # past it).  Settle significance conservatively: every frame
            # behind next_frame_to_decode must have a verdict or
            # skip_stills' find_possible_change loops on ('unknown', k)
            # forever (k is already behind the decode cursor, so no amount
            # of worker() calls can ever resolve it).
            elif state == DecoderState.ERROR:
                if frm.significant_changes is None:
                    frm.significant_changes = True
                self.next_frame_to_decode += 1
        else:
            res = self.decoder.decompress_p(frm.data, new_frame)
            frm.significant_changes = res.significant_changes
            if res.data is not None:
                if res.data is prev_frame:  # no changes: extend prev buffer
                    self._update_bufs(prev_idx, self.next_frame_to_decode, False)
                else:
                    self._update_bufs(free_idx, self.next_frame_to_decode, True)
            self.next_frame_to_decode += 1

        if external and self.seek_cb is not None:
            self._force_work(10)  # seek burst (Manager.hx:537-547)

    def _resume_loading(self) -> None:
        self.loading_pause = False

    def _force_work(self, n: int) -> None:
        # flat loop, no re-entry (force_work, Manager.hx:549-556)
        while n > 0 and self.seek_cb is not None:
            self.worker(external=False)
            n -= 1
            if not self._worker_can_progress():
                break

    def _frames_differ(self, pnt1: Optional[np.ndarray],
                       pnt2: Optional[np.ndarray], curfrm) -> bool:
        # frames_differ_significantly (Manager.hx:392-421)
        if self.next_frame_to_decode > 0:
            info = self.loader.get_frame_not_loading(self.next_frame_to_decode - 1)
            if info.status == FrameStatus.READY and info.frame.key \
                    and info.frame.data is not None:
                if len(info.frame.data) == len(curfrm.data):
                    return info.frame.data != curfrm.data
                return True
        else:
            return True
        if pnt1 is None or pnt2 is None:
            return True
        X = self.video_info.width
        lo = INSIGNIFICANT_LINES * X
        return bool((pnt1[lo:] != pnt2[lo:]).any())

    def _update_bufs(self, idx: int, frame_num: int, new_data: bool) -> None:
        # Manager.update_bufs (Manager.hx:568-578)
        b = self.bufs[idx]
        if b.trash:
            b.trash = False
            b.first = b.last = frame_num
        elif new_data or b.last != frame_num - 1:
            b.first = b.last = frame_num
        else:
            b.last = frame_num
        self._decoded(idx, frame_num)

    def _decoded(self, idx: int, frame_num: int) -> None:
        # Manager.decoded (Manager.hx:549-566)
        if frame_num == self.frame_of_interest:
            if self.delayed_fill is not None:
                self.delayed_fill(idx, frame_num / self.fps)
                self.delayed_fill = None
            if self.seek_cb is not None:
                cb = self.seek_cb
                self.seek_cb = None
                self._seek_finished()
                cb()

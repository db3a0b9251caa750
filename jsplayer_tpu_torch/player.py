"""Player facade — the embed/control API layer.

Parity surface: Main.hx's browser-facing machinery re-imagined headless:

  * the ExternalInterface JS API (Main.hx:1025-1034) becomes plain methods:
    spplay/sppause → play()/pause(), spposition → position(),
    spseek → seek(fraction), spload → load(), spnextchange → next_change(),
    spresize → resize();
  * the flashvars config block (Main.hx:233-264: fname, buffer size, UI
    colors, thumb/buttons) becomes PlayerConfig — one typed dataclass, no
    compile-time forks (SURVEY.md §5.6);
  * the 50 ms play tick (timer_play, Main.hx:1037, play_timer :1066-1136)
    becomes ``tick(now)``: computes stream time from the wall clock, asks the
    Manager for the frame, auto-pauses when video time passes loaded audio
    (Main.hx:1082-1091), fires on_frame/on_loaded callbacks;
  * frame-step/key-step hotkey handlers (Main.hx:1197-1216 key handling)
    become step_frame()/step_key().

The decode-ahead worker runs inline in tick() (``worker_steps`` per tick) —
the reference's 1 ms worker timer (Manager.hx:139-141) collapsed into the
same cooperative loop.
"""

from __future__ import annotations

import math
import time as _time
from dataclasses import dataclass, field
from typing import Callable, Optional

from .core.loader import DataLoader, DataLoaderAVIIndexed, DataLoaderAVISeq
from .core.source import ByteSource, open_source
from .core.types import VideoInfo
from .pipeline.manager import FrameResult, Manager


@dataclass
class PlayerConfig:
    """Runtime configuration ≙ flashvars (Main.hx:233-264)."""

    fname: str = ""
    indexed: bool = True  # ≙ -Dindexed build flag (Manager.hx:14-18)
    buffer_mb: int = 50  # 'buffer' flashvar → storage_limit (Main.hx:257-264)
    storage_limit_bytes: Optional[int] = None  # byte-granular override
    num_buffers: int = 8  # Main.hx:148
    autoskip: bool = False  # skip-stills auto mode (Main.hx:1083-1091)
    worker_steps_per_tick: int = 16
    # UI theming flashvars kept for API compatibility (Main.hx:244-249)
    colors: dict = field(default_factory=dict)
    # ≙ -Dwait deferred-load mode (Main.hx:266-276, 406-426): don't load
    # the stream until playback is requested; show `thumb` (an image URL,
    # the 'thumb' flashvar) with a start button until then
    wait: bool = False
    thumb: str = ""


class Player:
    def __init__(self, config: Optional[PlayerConfig] = None):
        self.config = config or PlayerConfig()
        self.manager: Optional[Manager] = None
        self.playing = False
        self.start_time = 0.0  # wall-clock at play start (Main.hx:1078)
        self.start_pos = 0.0
        self.first_shown = False
        self.video_info: Optional[VideoInfo] = None
        self.on_loaded: Optional[Callable[[], None]] = None  # ≙ on_player_loaded
        self.on_frame: Optional[Callable[[Manager], None]] = None
        self.on_next_change: Optional[Callable[[float], None]] = None  # ≙ on_next_btn
        self._auto_paused = False
        self._pending_skip = False
        self._pcm_cache = None
        self._clock = _time.monotonic

    # -- loading ----------------------------------------------------------------

    def load(self, source: ByteSource | str | None = None) -> VideoInfo:
        """≙ spload / initial open (Main.hx:273-275)."""
        if isinstance(source, str):
            source = open_source(source)
        elif source is None:
            source = open_source(self.config.fname)
        loader: DataLoader
        if self._sniff_lane(source):
            # .jlv lane container (this framework's serving format):
            # same Player surface, lane loader + host codec underneath
            from .core.lane_loader import LaneDataLoader

            loader = LaneDataLoader()
        elif self.config.indexed:
            limit = (self.config.storage_limit_bytes
                     if self.config.storage_limit_bytes is not None
                     else self.config.buffer_mb * 1_000_000)
            loader = DataLoaderAVIIndexed(storage_limit=limit)
        else:
            loader = DataLoaderAVISeq()
        if self.manager is not None:
            # loading over a live player: release the old stream first
            # (Main.js_load → Manager.StopAndClean, Manager.hx:81-95)
            self.manager.stop_and_clean()
        self.manager = Manager(loader, num_buffers=self.config.num_buffers)
        self._pcm_cache = None  # re-decoded lazily per loaded stream
        # fresh playback state: loading over a live player (spload) must
        # not inherit the old stream's clock, gating flag, or first-frame
        # latch (Main.js_load stops playback before re-opening)
        self.playing = False
        self.first_shown = False
        self.start_pos = 0.0
        self.start_time = 0.0
        self._auto_paused = False
        self._pending_skip = False
        # the old stream's header must not answer for this one: _on_open
        # sets it only when the new source has one (reference host fault 2)
        self.video_info = None
        self.manager.open(source, self._on_open)
        if self.video_info is None:
            raise ValueError(
                "no video header found (file truncated before avih/strf?)")
        return self.video_info

    @staticmethod
    def _sniff_lane(source) -> bool:
        """4-byte magic peek — works on file/memory/HTTP sources alike
        (HttpRangeSource turns it into one tiny ranged GET)."""
        from .codecs import lane_format

        try:
            return lane_format.is_lane_container(source.read_range(0, 4))
        except Exception:
            return False

    def _on_open(self, vi: VideoInfo) -> None:
        # Main.on_open (Main.hx:937-1052): size the surface, enable controls
        self.video_info = vi

    def unload(self) -> None:
        if self.manager is not None:
            self.manager.stop_and_clean()
            self.manager = None
        self._pcm_cache = None

    # -- transport control (ExternalInterface parity, Main.hx:1025-1034) --------

    def play(self) -> None:
        """≙ spplay."""
        if self.manager is None:
            return
        self.start_pos = self.manager.shown_time
        self.start_time = self._clock()
        self.playing = True
        self._auto_paused = False

    def pause(self) -> None:
        """≙ sppause.  Any pause — user or internal — clears the
        audio-gating flag: an explicit pause must not be overridden by the
        auto-resume path, and the gated path re-sets the flag itself."""
        if self.playing and self.manager is not None:
            self.start_pos = self.current_time()
        self.playing = False
        self._auto_paused = False

    def position(self) -> float:
        """≙ spposition: playback position as a fraction [0..1]."""
        if self.manager is None:
            return 0.0
        return self.manager.time_to_fraction(self.manager.shown_time)

    def current_time(self) -> float:
        if not self.playing:
            return self.start_pos
        return self._clock() - self.start_time + self.start_pos

    def seek(self, fraction: float,
             done: Optional[Callable[[], None]] = None) -> None:
        """≙ spseek (fraction of total time; Main.seek_start, Main.hx:1210-1216)."""
        if self.manager is None:
            return
        t = self.manager.fraction_to_time(fraction)
        self.seek_time(t, done)

    def seek_time(self, t: float, done: Optional[Callable[[], None]] = None
                  ) -> None:
        # hostile times (NaN/inf via the web /control JSON surface, which
        # python json parses): the Manager clamps its own frame math, but
        # start_pos feeds current_time() and the /state JSON — sanitize
        # here so the surfaced position is always finite and in range
        t = float(t)
        if not math.isfinite(t):
            t = 0.0
        t = min(max(t, 0.0), self.manager.fraction_to_time(1.0))
        self.manager.loader.audio_track.stop()

        def seek_done() -> None:
            self.start_pos = t
            self.start_time = self._clock()
            if done is not None:
                done()

        pending = self.manager.seek_to(t, seek_done)
        # drive the worker until the seek resolves (≙ force_work bursts)
        guard = 0
        while pending and self.manager.seek_cb is not None and guard < 100000:
            self.manager.worker()
            guard += 1

    def next_change(self) -> Optional[float]:
        """≙ spnextchange / js_nextdifferent (Main.hx:1307-1319): seek to the
        next significant change; None if still computing (call again)."""
        t = self.manager.skip_stills(first_call=not self._pending_skip)
        if t is None:
            self._pending_skip = True
            return None
        self._pending_skip = False
        self.seek_time(t)
        if self.on_next_change is not None:
            self.on_next_change(t)
        return t

    def thumbnail(self):
        """Decode and return the first frame's RGBA (u32 [H*W]) without
        starting playback — the ≙ of the -Dwait thumbnail/deferred-load mode
        (Main.hx:266-276, 406-426)."""
        from .pipeline.manager import FrameResult

        for _ in range(100000):
            if self.tick() == FrameResult.DECOMPRESSED and self.first_shown:
                break
        return self.manager.get_rgba()

    def resize(self, width: int, height: int) -> tuple[int, int]:
        """≙ spresize (Main.resizePlayer, Main.hx:1327-1338): aspect-fit."""
        vi = self.video_info
        if vi is None:
            return (width, height)
        scale = min(width / vi.width, height / vi.height)
        return (int(vi.width * scale), int(vi.height * scale))

    # -- frame stepping (hotkeys, Main.hx:1197-1208) -----------------------------

    def step_frame(self, forward: bool = True) -> None:
        m = self.manager
        t = m.next_frame_time() if forward else m.prev_frame_time()
        self.seek_time(t)

    def step_key(self, forward: bool = True) -> None:
        m = self.manager
        t = m.next_key_time() if forward else m.prev_key_time()
        self.seek_time(t)

    # -- the play tick (Main.play_timer, Main.hx:1066-1136) ----------------------

    def tick(self, now: Optional[float] = None) -> FrameResult:
        """One presentation tick: decode-ahead work + frame presentation +
        audio gating. Returns the frame result for the current time."""
        m = self.manager
        if m is None:
            return FrameResult.NOTSOON
        for _ in range(self.config.worker_steps_per_tick):
            m.worker()

        if not self.first_shown:
            # first frame (Main.hx:1093-1105)
            res = m.get_decompressed_frame(0.0, playing=False)
            if res == FrameResult.DECOMPRESSED:
                self.first_shown = True
                if self.on_loaded is not None:
                    self.on_loaded()
                if self.on_frame is not None:
                    self.on_frame(m)
            return res

        if not self.playing:
            # audio-gated auto-resume (Main.hx:1082-1091): the worker steps
            # above keep loading audio while paused; once the watermark
            # passes the paused position, playback resumes.  This must run
            # BEFORE the paused early-return or a gated pause is permanent.
            if self._auto_paused and self.start_pos <= m.loaded_audio_time():
                self._auto_paused = False
                self.play()
            if not self.playing:
                return FrameResult.DECOMPRESSED

        t = self.current_time()
        if t >= m.total_time():
            t = m.total_time()
            self.pause()  # end of stream (pause() clears the gating flag)
        res = m.get_decompressed_frame(t, playing=True)
        if res == FrameResult.DECOMPRESSED and self.on_frame is not None:
            self.on_frame(m)

        # auto-pause when playback passes loaded audio (Main.hx:1082-1091);
        # the flag is set AFTER pause() since pause() clears it
        if self.playing and t > m.loaded_audio_time():
            self.pause()
            self._auto_paused = True

        # autoskip: jump over stills while playing (auto_skip, Main.hx:1083-1091)
        if (self.config.autoskip and self.playing
                and res == FrameResult.DECOMPRESSED
                and m.loader.get_frame_changes(m.last_frame_drawn) is False):
            nt = m.skip_stills(first_call=not self._pending_skip)
            if nt is None:
                self._pending_skip = True
            else:
                self._pending_skip = False
                if nt > t:
                    self.seek_time(nt)
        return res

    # -- status surfaces (UI bars, Main.hx:1110-1125) ----------------------------

    def audio_pcm(self):
        """Decoded audio as one time-aligned float32 tensor (av.pcm.
        AlignedPcm), or None when the stream has no audio.  The decoded
        counterpart of the PlaybackPlan surface — what the reference gets
        from WebAudio decodeAudioData (AudioTrack.hx:54-65), here via the
        system codec backend.  Decoded lazily once per loaded stream;
        raises RuntimeError if the codec backend is unavailable."""
        if self._pcm_cache is None:
            from .av import pcm as _pcm
            # drain the MP3 scanner over everything loaded so far — the
            # worker only piggybacks ParseSound under buffer pressure
            # (Manager.hx:478-481), which a short stream may never create
            loader = self.manager.loader
            for _ in range(100000):
                mp = loader.mp3_parser
                before = (mp.frames_processed, len(mp.sections),
                          mp.parsing_complete)
                loader.parse_sound()
                if (mp.frames_processed, len(mp.sections),
                        mp.parsing_complete) == before:
                    break
            self._pcm_cache = _pcm.decode_track(loader.audio_track)
        return self._pcm_cache

    def audio_slice(self, t0: float, t1: float):
        """PCM samples covering [t0, t1) seconds, or None without audio —
        the playback-backend convenience over :meth:`audio_pcm`."""
        pcm = self.audio_pcm()
        return None if pcm is None else pcm.slice_seconds(t0, t1)

    def loaded_range(self) -> tuple[float, float]:
        m = self.manager
        return (m.loaded_fraction_start(), m.loaded_fraction_end())

    def worker_dot(self) -> float:
        return self.manager.worker_pos()

    def timecode(self) -> str:
        t = self.manager.shown_time
        mm, ss = divmod(int(t), 60)
        hh, mm = divmod(mm, 60)
        return f"{hh:02d}:{mm:02d}:{ss:02d}"

"""MP3 audio demux: frame-sync scan + section grouping + PTS model.

Parity with the reference's MP3Parser (MP3Parser.hx:19-257): scans '01wb'
payload bytes for MPEG audio frame syncs (is_valid_header, :113-122; frame
size math, :124-142), groups frames into ~5 s short sections (200 frames) and
~1 min long sections (2300 frames) with a 4-frame overlap so a WebAudio-style
consumer can decode gaplessly (generate_short_sound/generate_long_sound,
:203-240), and stamps each section with its start time from the
1152-samples-per-frame PTS model (:206-208).

Differences by design: no wall-clock time budget (the reference slices work
into 25 ms chunks, :63-79, because it shares the JS thread; here parsing runs
on a host worker and the `budget_bytes` arg of parse() is the cooperative
knob), and sections carry raw MP3 bytes + timing — the playback backend
(av/audio_track.py) tracks coverage/time_loaded instead of feeding WebAudio.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

from ..core.chunkbuffer import ChunkBuffer

FRAMES_IN_SECTION = 200  # ~5 s (MP3Parser.hx:38)
FRAMES_IN_LONG_SECTION = 2300  # ~1 min (MP3Parser.hx:39)
_OVERLAP = 4  # frames kept between consecutive sections (MP3Parser.hx:213,222)

_SAMPLING_RATES = (44100, 48000, 32000)  # MP3Parser.hx:35
_BITRATES = (
    -1, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320,
    -1, -1, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144, 160, -1,
)  # MP3Parser.hx:36-37
_VERSIONS = ("2.5", "err", "2", "1")  # MP3Parser.hx:34


def is_valid_header(h: int) -> bool:
    """MP3Parser.is_valid_header (MP3Parser.hx:113-122)."""
    return (
        ((h >> 21) & 2047) == 2047
        and ((h >> 19) & 3) != 1
        and ((h >> 17) & 3) != 0
        and ((h >> 12) & 15) != 0
        and ((h >> 12) & 15) != 15
        and ((h >> 10) & 3) != 3
        and (h & 3) != 2
    )


def frame_size(h: int) -> tuple[int, int]:
    """→ (size in bytes, sample_rate) (MP3Parser.frame_size, :124-142)."""
    version = (h >> 19) & 3
    bitrate_idx = (h >> 12) & 15
    sampling_idx = (h >> 10) & 3
    padding = (h >> 9) & 1
    actual_version = _VERSIONS[version]
    rate = _SAMPLING_RATES[sampling_idx]
    if actual_version == "2":
        rate >>= 1
    elif actual_version == "2.5":
        rate >>= 2
    y = (0 if actual_version == "1" else 1) * len(_BITRATES) >> 1
    bitrate = _BITRATES[y + bitrate_idx] * 1000
    per_frame = 144 if actual_version == "1" else 72
    return int(per_frame * bitrate / rate + padding), rate


@dataclass
class SoundSection:
    """One grouped section handed to the audio backend."""

    start_time: float
    data: bytes
    last: bool
    nframes: int
    sample_rate: int

    @property
    def duration(self) -> float:
        return self.nframes * 1152 / self.sample_rate


SectionHandler = Callable[[float, bytes, bool], None]


class Mp3Parser:
    """Incremental MP3 frame scanner over a ChunkBuffer (MP3Parser.hx:19)."""

    def __init__(self, buffer: ChunkBuffer,
                 section_handler: Optional[SectionHandler] = None):
        self.input = buffer
        self.section_handler = section_handler
        self.position = 0
        self.frames: list[tuple[int, int]] = []  # (start, length)
        self.long_frames: list[tuple[int, int]] = []
        self.frames_processed = 0
        self.long_frames_processed = 0
        self.sample_rate = 44100
        self.no_more_data = False
        self.parsing_complete = False
        self.started = False
        self.sections: list[SoundSection] = []  # all emitted sections

    def reset(self) -> None:
        """Forget all positional state.  Required whenever the owning
        loader clears ``self.input`` (seek/window eviction,
        DataLoaderAVIIndexed.hx:656-673): pending frame tuples and
        ``position`` are absolute offsets into the cleared buffer, and a
        later finalize would read them out of range."""
        self.position = 0
        self.frames = []
        self.long_frames = []
        self.frames_processed = 0
        self.long_frames_processed = 0
        self.no_more_data = False
        self.parsing_complete = False
        self.started = False

    def no_more_sound(self) -> bool:
        # MP3Parser.NoMoreSound (MP3Parser.hx:58-61); sections are emitted
        # synchronously here so there is no pending-decode count
        return self.no_more_data

    def on_data_end(self) -> None:
        self.no_more_data = True

    def parse(self, budget_bytes: Optional[int] = None) -> None:
        """Scan forward; cooperative budget in scanned bytes (replaces the
        reference's 25 ms wall-clock slice, MP3Parser.hx:63-79)."""
        if self.parsing_complete:
            return
        scanned = 0
        while True:
            progressed = self._do_parse_step()
            if not progressed:
                if self.no_more_data:
                    self.parsing_complete = True
                    self._generate_short(True)
                return
            scanned += progressed
            if budget_bytes is not None and scanned >= budget_bytes:
                return

    def _do_parse_step(self) -> int:
        """One frame (or resync byte run); → bytes consumed, 0 = blocked
        (MP3Parser.do_parse, :86-102)."""
        consumed = 0
        while self.input.bytes_available(self.position) >= 4:
            hd = self.input.read_u32be(self.position)
            if is_valid_header(hd):
                size, rate = frame_size(hd)
                self.sample_rate = rate
                if size <= 0:
                    self.position += 1
                    consumed += 1
                    continue
                if self.input.bytes_available(self.position) >= size:
                    self._add_frame(self.position, size)
                    self.position += size
                    return consumed + size
                return 0 if consumed == 0 else consumed
            self.position += 1
            consumed += 1
        return 0 if consumed == 0 else consumed

    def _add_frame(self, start: int, length: int) -> None:
        # MP3Parser.add_mp3_frame (:104-111)
        self.frames.append((start, length))
        if len(self.frames) >= FRAMES_IN_SECTION:
            self._generate_short(False)
        self.started = True

    def _generate_short(self, last_portion: bool) -> None:
        # MP3Parser.generate_short_sound (:203-229)
        frame_duration = 1152 / self.sample_rate
        start_time = frame_duration * self.frames_processed
        if not last_portion:
            self._emit(self.frames, start_time, False)
        to_long = self.frames if last_portion else self.frames[:-_OVERLAP]
        self.long_frames.extend(to_long)
        if last_portion:
            self.frames_processed += len(self.frames)
            self.frames = []
        else:
            saved = self.frames[-_OVERLAP:]
            self.frames_processed += len(self.frames) - _OVERLAP
            self.frames = saved
        if len(self.long_frames) >= FRAMES_IN_LONG_SECTION or last_portion:
            self._generate_long(last_portion)

    def _generate_long(self, last: bool) -> None:
        # MP3Parser.generate_long_sound (:231-240)
        frame_duration = 1152 / self.sample_rate
        start_time = frame_duration * self.long_frames_processed
        self._emit(self.long_frames, start_time, last)
        saved = self.long_frames[-_OVERLAP:]
        self.long_frames_processed += len(self.long_frames) - _OVERLAP
        self.long_frames = saved

    def _emit(self, frames: list[tuple[int, int]], start_time: float,
              last: bool) -> None:
        # MP3Parser.generate_sound (:242-255)
        if not frames:
            return
        data = b"".join(self.input.read(s, ln) for s, ln in frames)
        section = SoundSection(start_time, data, last, len(frames),
                               self.sample_rate)
        self.sections.append(section)
        if self.section_handler is not None:
            self.section_handler(start_time, data, last)

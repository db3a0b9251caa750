"""Audio track: section store, coverage merge, A/V sync watermark.

Parity with the reference's AudioTrack (AudioTrack.hx:33-202): decoded audio
fragments are kept sorted by start time; overlapping fragments are merged
keeping the best coverage (addFragmentSound, AudioTrack.hx:74-125); the
``time_loaded`` watermark — the end of the gapless prefix — gates playback
pause when video time passes audio availability (AudioTrack.hx:121-124, used
by the play tick, Main.hx:1082).

The reference plays through WebAudio (one AudioBufferSourceNode per play,
WASound.hx:15-24); this framework's consumers are ML pipelines and headless
servers, so a Fragment carries the raw MP3 section bytes + timing, and
``play(time)`` returns a PlaybackPlan (which fragment, byte payload, offset,
and when the next fragment begins) instead of touching an audio device.
Durations come from the MP3 PTS model (1152 samples/frame) rather than a
decoder — identical for conformant streams.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class Fragment:
    """AudioTrack.Fragment (AudioTrack.hx:12-31)."""

    start_time: float
    duration: float
    data: bytes

    @property
    def end_time(self) -> float:
        return self.start_time + self.duration


@dataclass
class PlaybackPlan:
    """What a playback backend needs to start sound at `time`."""

    fragment: Fragment
    offset: float  # seconds into the fragment
    next_start: Optional[float]  # when to chain the next fragment (or None)


class AudioTrack:
    def __init__(self) -> None:
        self.sections: list[Fragment] = []
        self.time_loaded = 0.0
        self.playing: Optional[PlaybackPlan] = None

    # -- ingestion -----------------------------------------------------------

    def add_fragment(self, start: float, data: bytes, last: bool,
                     duration: Optional[float] = None,
                     sample_rate: int = 44100, nframes: Optional[int] = None
                     ) -> None:
        """AddFragment (AudioTrack.hx:54-65). Duration from the PTS model if
        not given explicitly."""
        if duration is None:
            assert nframes is not None, "need duration or frame count"
            duration = nframes * 1152 / sample_rate
        self._add_fragment_sound(start, duration, data, last)

    def add_section(self, section) -> None:
        """Convenience: ingest an av.mp3.SoundSection."""
        self._add_fragment_sound(section.start_time, section.duration,
                                 section.data, section.last)

    def _add_fragment_sound(self, start: float, dur: float, data: bytes,
                            last: bool) -> None:
        """Overlap-merging insert keeping best coverage
        (addFragmentSound, AudioTrack.hx:74-125)."""
        frag = Fragment(start, dur, data)
        sections = self.sections
        n = len(sections)

        if n == 0:
            sections.append(frag)
            if start < 0.001:
                self.time_loaded = start + dur
            return

        i = 0
        while i < n and start - sections[i].start_time > 0.001:
            i += 1

        tmplist = sections[:i] + [frag]
        if last:
            self.sections = tmplist
        else:
            tmplist = tmplist + sections[i:]  # len n+1
            newlist: list[Fragment] = []
            time_covered = 0.0
            if (tmplist[1].start_time > tmplist[0].start_time + 0.001
                    or tmplist[0].end_time > tmplist[1].end_time + 0.001):
                newlist.append(tmplist[0])
                time_covered = tmplist[0].end_time
            for j in range(1, n):
                if (tmplist[j + 1].start_time < time_covered + 0.001
                        and tmplist[j + 1].end_time > tmplist[j].end_time):
                    pass  # fully dominated by neighbors — drop
                else:
                    newlist.append(tmplist[j])
                    time_covered = tmplist[j].end_time
            if tmplist[n].end_time - time_covered > 0.001:
                newlist.append(tmplist[n])
            self.sections = newlist

        # gapless-prefix watermark (AudioTrack.hx:121-124)
        self.time_loaded = 0.0
        for sec in self.sections:
            if sec.start_time - self.time_loaded < 0.001:
                self.time_loaded = sec.end_time

    # -- playback control ------------------------------------------------------

    def find_section(self, time: float) -> int:
        """Binary search (find_section, AudioTrack.hx:184-201); -1 = none."""
        lo, hi = 0, len(self.sections)
        while lo < hi:
            mid = (lo + hi) >> 1
            sec = self.sections[mid]
            next_start = (self.sections[mid + 1].start_time
                          if mid < len(self.sections) - 1 else sec.end_time)
            if sec.start_time <= time < next_start:
                return mid
            if time < sec.start_time:
                hi = mid
            else:
                lo = mid + 1
        return -1

    def play(self, time: float) -> Optional[PlaybackPlan]:
        """Play (AudioTrack.hx:127-157): → plan or None if no sound yet."""
        idx = self.find_section(time)
        if idx < 0:
            return None
        sec = self.sections[idx]
        next_start = (self.sections[idx + 1].start_time
                      if idx < len(self.sections) - 1 else None)
        plan = PlaybackPlan(sec, time - sec.start_time, next_start)
        self.playing = plan
        return plan

    def stop(self) -> None:
        self.playing = None

    def clear(self) -> None:
        # Clear (AudioTrack.hx:171-176)
        self.stop()
        self.sections = []
        self.time_loaded = 0.0

    def stop_and_clean(self) -> None:
        self.stop()
        self.clear()

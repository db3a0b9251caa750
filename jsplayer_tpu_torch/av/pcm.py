"""MP3 → time-aligned PCM tensors.

The reference never decodes MP3 itself — it hands each grouped section to
the browser's WebAudio ``decodeAudioData`` and schedules the resulting
buffers by start time (AudioTrack.hx:54-65, Play :127-157).  This module is
the headless equivalent: each :class:`~.audio_track.AudioTrack` fragment is
decoded with the system codec library (libavcodec via native/ffshim) and the
resulting samples are placed on one shared timeline at
``round(start_time * sample_rate)``, later fragments overwriting the 4-frame
section overlaps exactly like WebAudio playback would (the overlap exists to
hide decoder warm-up, MP3Parser.hx:203-240).

The result is an :class:`AlignedPcm`: a ``[n_samples, channels]`` float32
array whose sample k sits at time ``k / sample_rate`` — the audio tensor that
rides next to the video model tensors in
:class:`~..pipeline.ingest.VideoIngestPipeline` (SURVEY.md §7 step 9).  PTS
model: 1152 samples per MP3 frame (MP3Parser.hx:206).

Availability is gated on the ffshim build (:func:`available`); without
libavcodec the rest of the framework — sections, PTS, watermarks — is
unaffected, matching the reference degrading to video-only playback when
audio decode fails.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from ..native import ffshim
from ..utils.logging import LOG
from .audio_track import AudioTrack, Fragment

SAMPLES_PER_FRAME = 1152  # MPEG-1 Layer III (MP3Parser.hx:206)


def available() -> bool:
    """True when the system codec backend (libavcodec) is usable."""
    return ffshim.available()


@dataclass
class AlignedPcm:
    """PCM on an absolute timeline: ``samples[k]`` is at ``k/sample_rate``."""

    samples: np.ndarray  # [n, channels] float32
    sample_rate: int

    @property
    def channels(self) -> int:
        return self.samples.shape[1]

    @property
    def duration(self) -> float:
        return self.samples.shape[0] / self.sample_rate

    def sample_index(self, t: float) -> int:
        """Clamped sample index for time ``t`` (seconds)."""
        return min(max(int(round(t * self.sample_rate)), 0),
                   self.samples.shape[0])

    def slice_seconds(self, t0: float, t1: float) -> np.ndarray:
        return self.samples[self.sample_index(t0): self.sample_index(t1)]

    def slice_for_frames(self, frame0: int, nframes: int,
                         fps: float) -> np.ndarray:
        """PCM covering video frames ``[frame0, frame0+nframes)`` — the A/V
        alignment used when batching audio next to a video window."""
        return self.slice_seconds(frame0 / fps, (frame0 + nframes) / fps)


def decode_fragment(data: bytes) -> tuple[np.ndarray, int]:
    """Decode one fragment (whole MP3 frames) with a fresh decoder —
    the WebAudio-``decodeAudioData``-per-fragment model.  → (samples, rate).
    """
    with ffshim.FFMp3Decoder() as dec:
        pcm = dec.decode(data)
        return pcm, dec.sample_rate


def decode_track(track: AudioTrack) -> Optional[AlignedPcm]:
    """Decode every fragment of an AudioTrack onto one aligned timeline.

    Returns None for a track with no sections.  Raises RuntimeError when the
    codec backend is unavailable (callers that can proceed video-only should
    check :func:`available` first)."""
    if not track.sections:
        return None
    if not available():
        raise RuntimeError(
            "MP3→PCM needs the system codec backend (libavcodec); build "
            "jsplayer_tpu/native/libffshim.so or consume the raw sections "
            "from AudioTrack instead")
    decoded: List[tuple[int, np.ndarray]] = []  # (start_sample, pcm)
    rate = 0
    channels = 0
    for frag in track.sections:
        try:
            pcm, r = decode_fragment(frag.data)
        except ValueError:
            # a fragment the codec rejects is dropped, playback continues —
            # the reference's decodeAudioData error path (AudioTrack.hx:63
            # logs "decode failed for fragment" and keeps going)
            LOG.mlog(f"pcm: decode failed for fragment at t={frag.start_time}")
            continue
        if pcm.shape[0] == 0:
            continue
        if rate == 0:
            rate, channels = r, pcm.shape[1]
        elif (r, pcm.shape[1]) != (rate, channels):
            raise ValueError(
                f"inconsistent audio format across sections: "
                f"{(r, pcm.shape[1])} vs {(rate, channels)}")
        decoded.append((int(round(frag.start_time * r)), pcm))
    if not decoded:
        return None
    total = max(s + p.shape[0] for s, p in decoded)
    out = np.zeros((total, channels), dtype=np.float32)
    # fragments are kept sorted by start; later fragments overwrite the
    # section overlap, like chained WebAudio buffers (AudioTrack.hx:127-157)
    for start, pcm in decoded:
        out[start: start + pcm.shape[0]] = pcm
    return AlignedPcm(out, rate)


def decode_tracks(tracks: Sequence[AudioTrack]) -> List[Optional[AlignedPcm]]:
    """Batch helper for VideoIngestPipeline.audio_tracks."""
    return [decode_track(t) for t in tracks]

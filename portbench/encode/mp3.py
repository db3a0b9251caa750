"""An MP3 audio track for a stream, made from its content seed.

A configuration's ``"audio": {"format": "mp3", "bitrate_kbps": ..,
"sample_rate": .., "channels": ..}`` names this module.  ``track`` writes
MPEG-1 Layer III frames (ISO/IEC 11172-3 2.4.1.3): a four-byte header
(sync, MPEG-1, Layer III, no CRC, the bitrate and sampling indices, the
padding bit, stereo or mono, "original"), then payload bytes drawn from
the seed.  A frame holds 1152 samples and 144 * bitrate / sample_rate
bytes; where that is not whole, the padding bit adds a byte as a constant
bitrate encoder sets it, so that frames 0..i-1 hold floor(i * 144 *
bitrate / sample_rate) bytes together (at 128 kbps and 44.1 kHz: frames of
417 and 418 bytes, 417.96 on average).  The payload is no decodable audio:
the port passes MP3 through, and the judge compares bytes and times.

The frames cover the video: ceil(T / fps * sample_rate / 1152) of them for
T video frames at `fps` (327 for 128 frames at 15 frames/s, 44.1 kHz).
They are interleaved as captures interleave them: after video frame t one
``01wb`` chunk holds the frames whose first sample falls in [t / fps,
(t + 1) / fps) s.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np

SAMPLES = 1152  # a Layer III frame's samples
# ISO/IEC 11172-3 table: MPEG-1 Layer III bitrate (kbit/s) by index 1..14,
# sampling frequency by index 0..2
BITRATES_KBPS = (32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256,
                 320)
SAMPLE_RATES = (44100, 48000, 32000)


def header(bitrate_kbps: int, sample_rate: int, channels: int,
           padding: int) -> bytes:
    """The four header bytes of one frame."""
    if bitrate_kbps not in BITRATES_KBPS:
        raise ValueError(f"MPEG-1 Layer III has no {bitrate_kbps} kbit/s")
    if sample_rate not in SAMPLE_RATES:
        raise ValueError(f"MPEG-1 has no sampling rate {sample_rate}")
    if channels not in (1, 2):
        raise ValueError(f"{channels} channels: MP3 holds 1 or 2")
    h = (0x7FF << 21 | 3 << 19 | 1 << 17 | 1 << 16
         | (BITRATES_KBPS.index(bitrate_kbps) + 1) << 12
         | SAMPLE_RATES.index(sample_rate) << 10 | padding << 9
         | (0 if channels == 2 else 3) << 6 | 1 << 2)
    return h.to_bytes(4, "big")


def frame_sizes(n: int, bitrate_kbps: int, sample_rate: int) -> list[int]:
    """The bytes of frames 0..n-1 of a constant bitrate stream."""
    num, den = 144 * 1000 * bitrate_kbps, sample_rate
    return [(i + 1) * num // den - i * num // den for i in range(n)]


def frame_count(video_frames: int, fps: float, sample_rate: int) -> int:
    """Frames that cover `video_frames` at `fps`."""
    return -(-video_frames * sample_rate // (Fraction(fps) * SAMPLES))


def chunk_of(k: int, fps: float, sample_rate: int) -> int:
    """The video frame after which frame k's chunk comes: the t whose
    [t / fps, (t + 1) / fps) holds frame k's first sample."""
    return int(k * SAMPLES * Fraction(fps) // sample_rate)


def wave_format(bitrate_kbps: int, sample_rate: int, channels: int) -> dict:
    """The audio stream's strh/strf fields (mux_avi's `sound_format`)."""
    return {"tag": 0x55, "channels": channels, "rate": sample_rate,
            "bytes_per_s": bitrate_kbps * 1000 // 8}


def track(seed: int, video_frames: int, fps: float, bitrate_kbps: int = 128,
          sample_rate: int = 44100, channels: int = 2) -> tuple:
    """(frames, chunks): the track's frames as bytes, in order, and the
    ``01wb`` chunks [(after video frame t, payload)] that carry them."""
    n = frame_count(video_frames, fps, sample_rate)
    sizes = frame_sizes(n, bitrate_kbps, sample_rate)
    unpadded = 144 * 1000 * bitrate_kbps // sample_rate
    rng = np.random.default_rng([seed, 0x6D7033])
    body = rng.integers(0, 256, sum(sizes) - 4 * n, dtype=np.uint8).tobytes()
    frames, at = [], 0
    for s in sizes:
        frames.append(header(bitrate_kbps, sample_rate, channels,
                             s - unpadded) + body[at:at + s - 4])
        at += s - 4
    by_chunk: dict = {}
    for k, f in enumerate(frames):
        by_chunk.setdefault(chunk_of(k, fps, sample_rate), []).append(f)
    return frames, [(t, b"".join(fs)) for t, fs in sorted(by_chunk.items())]

"""Synthetic MP3 frame generator — fixtures for the audio demux path.

Emits byte streams of spec-valid MPEG audio frame headers + dummy payloads,
sized exactly per the parser's frame-size model (av/mp3.py ≙
MP3Parser.hx:124-142), so section grouping and PTS math can be tested without
real audio content.
"""

from __future__ import annotations

import struct

from ..av.mp3 import frame_size


def make_header(bitrate_idx: int = 9, sampling_idx: int = 0,
                padding: int = 0) -> int:
    """MPEG1 Layer III header word (big-endian)."""
    h = 0x7FF << 21  # sync
    h |= 3 << 19  # MPEG1
    h |= 1 << 17  # Layer III
    h |= 1 << 16  # no CRC
    h |= bitrate_idx << 12
    h |= sampling_idx << 10
    h |= padding << 9
    h |= 0 << 6  # stereo
    return h


def make_frames(n: int, bitrate_idx: int = 9, sampling_idx: int = 0,
                filler: int = 0xAA) -> tuple[bytes, int, int]:
    """→ (stream bytes, frame_count, sample_rate)."""
    h = make_header(bitrate_idx, sampling_idx)
    size, rate = frame_size(h)
    hdr = struct.pack(">I", h)
    frame = hdr + bytes([filler]) * (size - 4)
    return frame * n, n, rate


def with_garbage(stream: bytes, leading: bytes = b"\x01\x02junk",
                 trailing: bytes = b"\x00tail") -> bytes:
    """Wrap a stream in non-sync garbage (exercises the resync scan,
    MP3Parser.hx:86-102)."""
    return leading + stream + trailing


def make_silence_frames(n: int, bitrate_idx: int = 9, sampling_idx: int = 0,
                        stereo: bool = False) -> tuple[bytes, int, int]:
    """→ (stream bytes, frame_count, sample_rate) of *decodable* MPEG-1
    Layer III silence.

    Unlike :func:`make_frames` (dummy 0xAA payloads, parser-only fixtures),
    these frames are valid for a real decoder: an all-zero side-info block
    (17 bytes mono / 32 stereo) encodes part2_3_length=0 for every granule,
    i.e. an empty spectrum, which any conformant Layer-III decoder
    reconstructs as 1152 samples of silence.  Used by the av.pcm tests to
    exercise the MP3→PCM path end-to-end."""
    h = make_header(bitrate_idx, sampling_idx)
    if not stereo:
        h |= 0b11 << 6  # channel mode: single channel
    size, rate = frame_size(h)
    hdr = struct.pack(">I", h)
    frame = hdr + b"\x00" * (size - 4)
    return frame * n, n, rate

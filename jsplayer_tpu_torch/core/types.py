"""Core data types for the TPU-native AVI decode framework.

Parity notes: these mirror the reference's data model (VideoData.hx:6-91) —
``VideoInfo`` (VideoData.hx:82-91), ``CompressedFrame`` (VideoData.hx:68-73),
``CodecType`` (VideoData.hx:75-80) and the OpenDML index records
(``SuperIndexEntry``/``StdIndexEntry``/``Index``, VideoData.hx:6-61) — but are
plain Python dataclasses; 64-bit file offsets are native ints (the reference
needed a hand-rolled Int64, Int64.hx:36-51, only because JS lacks one).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional


class CodecType(enum.Enum):
    """Codec selector (VideoData.hx:75-80). Unlike the reference, MSVC support
    is always compiled in (no ``-Dmsvc`` build fork; see SURVEY.md §5.6)."""

    SCREENPRESSOR = "screenpressor"
    MSVC16 = "msvc16"
    MSVC8 = "msvc8"
    # not in the reference enum: this framework's own lane-container
    # serving format, playable through the same Manager surface
    # (core/lane_loader.py + codecs/lane_host.py)
    LANE = "lane"


@dataclass
class VideoInfo:
    """Stream-level metadata extracted from the AVI header (VideoData.hx:82-91)."""

    width: int
    height: int
    bpp: int
    fps: float
    nframes: int
    codec: CodecType
    palette: Optional[bytes] = None
    riff_size: int = 0xFFFFFFFF


@dataclass
class CompressedFrame:
    """One demuxed video chunk (VideoData.hx:68-73).

    ``significant_changes`` is a tri-state: None = not yet decoded,
    True/False = decoder's idle-frame verdict (used by skip-stills).
    """

    key: bool
    data: Optional[bytes]
    ix: int = -1  # which Index this frame belongs to; -1 = none
    significant_changes: Optional[bool] = None


@dataclass
class SuperIndexEntry:
    """OpenDML super-index ('indx') entry (VideoData.hx:6-23)."""

    off: int  # absolute file offset of the sub-index ('ix##') chunk
    size: int  # size in bytes of that chunk
    duration: int  # number of frames it covers


@dataclass
class StdIndexEntry:
    """OpenDML standard-index entry (VideoData.hx:25-39).

    ``off`` points at the chunk *header* (the reference subtracts 8 from the
    stored data offset, VideoData.hx:33); ``key`` is bit31 of size inverted.
    """

    off: int
    size: int
    key: bool


@dataclass
class Index:
    """A contiguous frame-range index segment (VideoData.hx:41-61)."""

    first_frame: int = 0
    last_frame: int = 0
    base_offset: int = 0  # added to per-frame offsets
    idx_offset: int = 0  # where the ix## chunk lives in the file
    size_in_bytes: int = 0
    frames: Optional[list[StdIndexEntry]] = None

    @staticmethod
    def from_super(entry: SuperIndexEntry, start_frame: int) -> "Index":
        # VideoData.hx:52-60
        return Index(
            first_frame=start_frame,
            last_frame=start_frame + entry.duration - 1,
            idx_offset=entry.off,
            size_in_bytes=entry.size,
        )


class FrameStatus(enum.Enum):
    """Loader answer for a frame request (DataLoader.hx:18)."""

    READY = "ready"
    NOT_READY = "not_ready"
    LOADING = "loading"


@dataclass
class FrameInfo:
    status: FrameStatus
    frame: Optional[CompressedFrame] = None


# FOURCC helpers -------------------------------------------------------------

def fourcc(tag: str) -> int:
    """Little-endian fourcc as the reference's Hex() (Parser.hx DSL)."""
    b = tag.encode("latin-1")
    assert len(b) == 4
    return b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24)


VIDEO_STREAM_MASK = 0x640000  # '..d?' chunk ids, DataLoader.hx:271
AUDIO_STREAM_MASK = 0x770000  # '..w?' chunk ids, DataLoader.hx:285

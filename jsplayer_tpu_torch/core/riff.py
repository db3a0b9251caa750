"""Incremental RIFF/AVI demuxer.

TPU-native replacement for the reference's parser-combinator AVI grammar
(AVIParser.hx:142-184 over Parser.hx:85-344).  The combinator machinery exists
in the reference only because JS cannot block on I/O — a parser parks its
continuation in ``Parser.current`` on underrun (Parser.hx:53-57).  Here a
Python generator *is* the continuation: parsing code suspends with ``yield``
whenever the `ChunkBuffer` lacks bytes and resumes when more arrive, so the
grammar reads as straight-line code.

Grammar parity map (all cites AVIParser.hx):
  RIFF/'AVI ' top level ......... Start():170-171
  LIST hdrl / avih .............. :166-168 (got_avih :42-62)
  LIST strl / strh vids+strf .... :153-165 (got_vstream_format :64-88)
  strh auds / strf .............. :159-160 (handlers are no-ops, :132-140)
  indx chunk .................... :157 (got_indx :90-120)
  LIST movi / sub_chunk ......... :152
  LIST rec ...................... :150
  00dc/00db frame, 01wb sound ... :144-145
  ix00/ix01 ..................... :146 (got_ix :122-125)
  mid-file restart .............. avi_part :178, StartFromMiddle :202-207
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Callable, Optional

from .chunkbuffer import ChunkBuffer
from .types import (
    CodecType,
    Index,
    StdIndexEntry,
    SuperIndexEntry,
    VideoInfo,
    fourcc,
)

class _Truncated(Exception):
    """Raised inside the parse generator when EOF hits mid-structure."""


_LIST = fourcc("LIST")
_RIFF = fourcc("RIFF")
_JUNK = fourcc("JUNK")

FRAME_TAGS = (fourcc("00dc"), fourcc("00db"))
SOUND_TAG = fourcc("01wb")
IX_TAGS = (fourcc("ix00"), fourcc("ix01"))
INDX_TAG = fourcc("indx")
IDX1_TAG = fourcc("idx1")


@dataclass
class IndxData:
    """Decoded 'indx' chunk — either a super index or an inline std index
    (mirrors the Indx_data enum, VideoData.hx:63-66)."""

    ckid: int
    super_entries: Optional[list[SuperIndexEntry]] = None
    std_entries: Optional[list[StdIndexEntry]] = None
    std_offset: int = 0


# Header sanity bounds (untrusted input): a corrupted avih once drove a
# 134 GiB frame-buffer allocation in the fuzz suite.  The reference's JS
# would OOM the tab just as silently; a server-side framework must reject.
MAX_DIM = 32768           # per-axis pixels
MAX_PIXELS = 1 << 27      # ~134 M px ≈ 8K×16K frame buffer (512 MB u32)
MAX_NFRAMES = 1 << 24


def _check_geometry(width: int, height: int, nframes: int) -> None:
    if not (0 < width <= MAX_DIM and 0 < height <= MAX_DIM
            and width * height <= MAX_PIXELS):
        raise ValueError(
            f"implausible AVI geometry {width}x{height} (corrupt header?)")
    if not (0 <= nframes <= MAX_NFRAMES):
        raise ValueError(f"implausible AVI frame count {nframes}")


def parse_avih(payload: bytes, file_size: int) -> VideoInfo:
    """Main AVI header → VideoInfo (got_avih, AVIParser.hx:42-62)."""
    (microsec, _maxbps, _padgran, _flags, totalframes, _initial, _nstreams,
     _suggbuf, width, height) = struct.unpack_from("<10i", payload, 0)
    if microsec <= 0:
        # ==0 default per AVIParser.hx:59; negative (hostile/corrupt signed
        # field) would otherwise yield a negative fps that silently breaks
        # every time↔frame mapping downstream
        microsec = 66666  # default 15 fps
    _check_geometry(width, height, totalframes)
    return VideoInfo(
        width=width, height=height, bpp=32, fps=1_000_000 / microsec,
        nframes=totalframes, codec=CodecType.SCREENPRESSOR,
        palette=None, riff_size=file_size,
    )


def parse_strf_video(payload: bytes, vi: VideoInfo, strh_fourcc: int,
                     strh_nframes: int) -> VideoInfo:
    """BITMAPINFOHEADER → codec select + palette (got_vstream_format,
    AVIParser.hx:64-88)."""
    _check_geometry(vi.width, vi.height, strh_nframes)
    vi.nframes = strh_nframes
    bits = struct.unpack_from("<H", payload, 14)[0]
    vi.bpp = bits
    fcc = strh_fourcc
    if fcc == 0:
        fcc = struct.unpack_from("<I", payload, 16)[0]
    if fcc in (fourcc("MSVC"), fourcc("msvc"), fourcc("CRAM")) or fcc == 0:
        vi.codec = CodecType.MSVC8 if bits == 8 else CodecType.MSVC16
    else:
        vi.codec = CodecType.SCREENPRESSOR
    if bits == 8 and len(payload) > 40:
        vi.palette = payload[40:]  # AVIParser.hx:79-85
    return vi


def parse_indx(payload: bytes) -> Optional[IndxData]:
    """'indx' chunk body (got_indx, AVIParser.hx:90-120)."""
    if len(payload) < 24:
        return None
    longs_per_entry = struct.unpack_from("<H", payload, 0)[0]
    entries_used = struct.unpack_from("<I", payload, 4)[0]
    ckid = struct.unpack_from("<I", payload, 8)[0]
    if longs_per_entry == 4:  # super index
        pos = 24  # 12 header bytes after ckid skipped (AVIParser.hx:102)
        entries = []
        for _ in range(entries_used):
            off_lo, off_hi, size, duration = struct.unpack_from("<IIII", payload, pos)
            entries.append(SuperIndexEntry(off=off_lo | (off_hi << 32),
                                           size=size, duration=duration))
            pos += 16
        return IndxData(ckid=ckid, super_entries=entries)
    if longs_per_entry == 2:  # std index inline
        off_lo, off_hi = struct.unpack_from("<II", payload, 12)
        pos = 24  # 4 reserved bytes skipped (AVIParser.hx:111-112)
        entries = []
        for _ in range(entries_used):
            off, size = struct.unpack_from("<II", payload, pos)
            entries.append(StdIndexEntry(off=off - 8, size=size & 0x7FFFFFFF,
                                         key=(size & 0x80000000) == 0))
            pos += 8
        return IndxData(ckid=ckid, std_entries=entries,
                        std_offset=off_lo | (off_hi << 32))
    return None


def parse_ix(payload: bytes) -> tuple[int, int, list[StdIndexEntry]]:
    """'ix##' chunk body (w/o 8-byte chunk header) → (ckid, base_offset,
    entries).  Mirrors DataLoader.parse_ix (DataLoader.hx:321-361) including
    the zero-offset carry-forward for sparse entries (:339-344)."""
    if len(payload) < 24:
        raise ValueError(f"truncated ix chunk ({len(payload)} bytes)")
    nentries = struct.unpack_from("<I", payload, 4)[0]
    if nentries > (len(payload) - 24) // 8:
        # advertised count exceeds the payload: raise the documented
        # corrupt-container error instead of letting struct.error escape
        # the synchronous _load_ix seek path
        raise ValueError(
            f"ix chunk claims {nentries} entries, payload holds "
            f"{(len(payload) - 24) // 8}")
    ckid = struct.unpack_from("<I", payload, 8)[0]
    off_lo, off_hi = struct.unpack_from("<II", payload, 12)
    base_offset = off_lo | (off_hi << 32)
    pos = 24
    entries = []
    last_off = 0
    for _ in range(nentries):
        off, size = struct.unpack_from("<II", payload, pos)
        if off == 0:
            off = last_off
        else:
            last_off = off
        entries.append(StdIndexEntry(off=off - 8, size=size & 0x7FFFFFFF,
                                     key=(size & 0x80000000) == 0))
        pos += 8
    return ckid, base_offset, entries


def parse_idx1(payload: bytes) -> tuple[list[StdIndexEntry], list[StdIndexEntry], int]:
    """'idx1' chunk body → (video entries, audio entries, first_offset).
    Mirrors DataLoaderAVIIndexed.parse_idx1 (DataLoaderAVIIndexed.hx:276-350)."""
    video: list[StdIndexEntry] = []
    audio: list[StdIndexEntry] = []
    first_offset = -1
    for pos in range(0, len(payload) - 15, 16):
        ckid, flags, off, size = struct.unpack_from("<IIII", payload, pos)
        if first_offset < 0:
            first_offset = off
        e = StdIndexEntry(off=off, size=size, key=(flags & 16) > 0)
        stream = ckid & 0xFF0000
        if stream == 0x640000:
            video.append(e)
        elif stream == 0x770000:
            audio.append(e)
    return video, audio, first_offset


class AviDemuxer:
    """Resumable AVI demuxer over a ChunkBuffer.

    Callbacks mirror the AVIParser constructor args (AVIParser.hx:24-35):
      on_frame(bytes)            — video chunk payload
      on_sound(bytes)            — audio chunk payload
      on_video_info(VideoInfo)   — after strh/strf parsed
      on_indx(IndxData)          — OpenDML 'indx' in header
      on_ix(payload, chunk_pos)  — 'ix##' met inline in movi; chunk_pos is the
                                   chunk-header position relative to stream
                                   start (GetVar("ix_size_pos")-4, AVIParser.hx:124)

    ``movi_size_pos`` is recorded like the reference's VarP (AVIParser.hx:152)
    for idx1 location math (DataLoaderAVIIndexed.hx:143-145, 319-323).
    """

    def __init__(
        self,
        buffer: ChunkBuffer,
        on_frame: Callable[[bytes], None],
        on_video_info: Optional[Callable[[VideoInfo], None]] = None,
        on_sound: Optional[Callable[[bytes], None]] = None,
        on_indx: Optional[Callable[[IndxData], None]] = None,
        on_ix: Optional[Callable[[bytes, int], None]] = None,
    ) -> None:
        self._buf = buffer
        self._pos = 0
        self.on_frame = on_frame
        self.on_sound = on_sound
        self.on_video_info = on_video_info
        self.on_indx = on_indx
        self.on_ix = on_ix
        self.active = False
        self.finished = False
        self._eof = False
        self._gen = None
        # recorded grammar variables (Parser.hx mem equivalents)
        self.file_size = 0
        self.movi_size = 0
        self.movi_size_pos = -1
        self._strh_fourcc = 0
        self._strh_nframes = 0
        self._video_info: Optional[VideoInfo] = None

    # -- driver API ----------------------------------------------------------

    def start(self) -> None:
        """AVIParser.Start (AVIParser.hx:142-184)."""
        self.active = True
        self.finished = False
        self._gen = self._parse_riff()

    def start_from_middle(self) -> None:
        """AVIParser.StartFromMiddle (AVIParser.hx:202-207): parse a bare
        sub_chunk sequence from an arbitrary (chunk-aligned) file position."""
        self.active = True
        self.finished = False
        self._gen = self._parse_chunk_sequence(None)

    def pump(self) -> bool:
        """AVIParser.Go (AVIParser.hx:186-194): advance until underrun or
        completion. Returns True if the demuxer is still active."""
        if not self.active or self._gen is None:
            return False
        try:
            next(self._gen)
            return True  # yielded: needs more data
        except (StopIteration, _Truncated):
            self._complete()
            return False
        except struct.error as e:
            # corrupt header: a mutated size field delivered a payload
            # shorter than its fixed-layout struct — the defined failure
            # mode for untrusted containers is ValueError
            raise ValueError(f"corrupt AVI header chunk: {e}") from e

    def signal_eof(self) -> None:
        """Driver marks that no further chunks will arrive (XHR COMPLETE,
        DataLoader.on_complete, DataLoader.hx:189-194)."""
        self._eof = True

    def _complete(self) -> None:
        self.active = False
        self.finished = True
        self._gen = None

    # -- generator plumbing --------------------------------------------------

    def _need(self, n: int):
        while self._buf.bytes_available(self._pos) < n:
            if self._eof:
                raise _Truncated  # truncated tail: finish quietly
            yield None

    def _read(self, n: int):
        yield from self._need(n)
        data = self._buf.read(self._pos, n)
        self._pos += n
        return data

    def _read_u32(self):
        d = yield from self._read(4)
        return None if d is None else (d[0] | (d[1] << 8) | (d[2] << 16) | (d[3] << 24))

    def _skip(self, n: int):
        # skip without materializing (large unknown chunks)
        yield from self._need(n)
        self._pos += n
        return True

    @staticmethod
    def _pad(size: int) -> int:
        return size + (size & 1)  # ParserUtils "pad" (ParserUtils.hx:10-38)

    # -- grammar -------------------------------------------------------------

    def _parse_riff(self):
        tag = yield from self._read_u32()
        if tag != _RIFF:
            return
        self.file_size = yield from self._read_u32()
        if self.file_size is None:
            return
        form = yield from self._read_u32()
        if form != fourcc("AVI "):
            return
        end = self._pos + self.file_size - 4
        while self._pos < end:
            done = yield from self._parse_toplevel_item()
            if done:
                break

    def _parse_toplevel_item(self):
        """list_hdrl | list_movi | other_chunk (AVIParser.hx:170)."""
        tag = yield from self._read_u32()
        if tag is None:
            return True
        size = yield from self._read_u32()
        if size is None:
            return True
        if tag == _LIST:
            size_pos = self._pos - 4
            ltype = yield from self._read_u32()
            if ltype is None:
                return True
            if ltype == fourcc("hdrl"):
                yield from self._parse_hdrl(size - 4)
            elif ltype == fourcc("movi"):
                self.movi_size = size
                self.movi_size_pos = size_pos
                yield from self._parse_chunk_sequence(self._pos + size - 4)
            else:
                ok = yield from self._skip(self._pad(size) - 4)
                if not ok:
                    return True
        else:
            ok = yield from self._skip(self._pad(size))
            if not ok:
                return True
        return False

    def _parse_hdrl(self, size: int) -> object:
        """LIST hdrl: avih + strl lists (AVIParser.hx:166-168)."""
        end = self._pos + size
        tag = yield from self._read_u32()
        avih_size = yield from self._read_u32()
        if tag != fourcc("avih") or avih_size is None:
            return
        payload = yield from self._read(self._pad(avih_size))
        if payload is None:
            return
        self._video_info = parse_avih(payload[:avih_size], self.file_size)
        while self._pos < end:
            yield from self._parse_hdrl_item(end)

    def _parse_hdrl_item(self, end: int):
        tag = yield from self._read_u32()
        size = yield from self._read_u32()
        if tag is None or size is None:
            self._pos = end
            return
        if tag == _LIST:
            ltype = yield from self._read_u32()
            if ltype == fourcc("strl"):
                yield from self._parse_strl(size - 4)
            else:
                yield from self._skip(self._pad(size) - 4)
        else:
            yield from self._skip(self._pad(size))

    def _parse_strl(self, size: int):
        """LIST strl: vids/auds strh+strf, indx (AVIParser.hx:153-165)."""
        end = self._pos + size
        stream_type = None
        while self._pos < end:
            tag = yield from self._read_u32()
            csize = yield from self._read_u32()
            if tag is None or csize is None:
                self._pos = end
                return
            if tag == fourcc("strh"):
                payload = yield from self._read(self._pad(csize))
                if payload is None:
                    return
                stream_type = struct.unpack_from("<I", payload, 0)[0]
                if stream_type == fourcc("vids"):
                    # fourcc at +4, nframes at +32 (AVIParser.hx:154-155:
                    # 'vids', Var(fourcc), Blob(24), Var(nframes))
                    self._strh_fourcc = struct.unpack_from("<I", payload, 4)[0]
                    self._strh_nframes = struct.unpack_from("<I", payload, 32)[0]
            elif tag == fourcc("strf"):
                payload = yield from self._read(self._pad(csize))
                if payload is None:
                    return
                if stream_type == fourcc("vids") and self._video_info is not None:
                    vi = parse_strf_video(payload[:csize], self._video_info,
                                          self._strh_fourcc, self._strh_nframes)
                    if self.on_video_info:
                        self.on_video_info(vi)
            elif tag == INDX_TAG:
                payload = yield from self._read(self._pad(csize))
                if payload is None:
                    return
                if self.on_indx:
                    data = parse_indx(payload[:csize])
                    if data is not None:
                        self.on_indx(data)
            else:
                ok = yield from self._skip(self._pad(csize))
                if not ok:
                    return

    def _parse_chunk_sequence(self, end: Optional[int]):
        """sub_chunk* — the movi body or a mid-file restart (AVIParser.hx:
        144-152, 178).  ``end=None`` means run until EOF (avi_part's
        0x7FFFFFFF limit)."""
        while end is None or self._pos < end:
            chunk_pos = self._pos
            tag = yield from self._read_u32()
            if tag is None:
                return
            size = yield from self._read_u32()
            if size is None:
                return
            if tag == _LIST:
                ltype = yield from self._read_u32()
                if ltype is None:
                    return
                if ltype == fourcc("rec "):
                    yield from self._parse_chunk_sequence(self._pos + size - 4)
                else:
                    ok = yield from self._skip(self._pad(size) - 4)
                    if not ok:
                        return
            elif tag in FRAME_TAGS:
                payload = yield from self._read(self._pad(size))
                if payload is None:
                    return
                self.on_frame(payload[:size])
            elif tag == SOUND_TAG:
                payload = yield from self._read(self._pad(size))
                if payload is None:
                    return
                if self.on_sound:
                    self.on_sound(payload[:size])
            elif tag in IX_TAGS:
                payload = yield from self._read(self._pad(size))
                if payload is None:
                    return
                if self.on_ix:
                    self.on_ix(payload[:size], chunk_pos)
            else:
                ok = yield from self._skip(self._pad(size))
                if not ok:
                    return

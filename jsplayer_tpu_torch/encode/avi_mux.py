"""AVI muxer — fixture generator for the demux/decode test suite.

The reference ships no encoder or fixtures (SURVEY.md §4); this muxer emits
spec-conformant RIFF/AVI files exercising the exact grammar the demuxer
consumes (AVIParser.hx:142-184): hdrl (avih + strl strh/strf), movi with
00dc/01wb chunks (optionally wrapped in LIST rec), idx1, and OpenDML
indx/ix00 super-index layout for the indexed-loader paths
(DataLoader.hx:266-401, DataLoaderAVIIndexed.hx:276-350).
"""

from __future__ import annotations

import struct
from typing import Optional, Sequence


def _chunk(tag: bytes, payload: bytes) -> bytes:
    data = tag + struct.pack("<I", len(payload)) + payload
    if len(payload) & 1:
        data += b"\x00"
    return data


def _list(ltype: bytes, payload: bytes) -> bytes:
    return _chunk(b"LIST", ltype + payload)


def _avih(width: int, height: int, nframes: int, fps: float) -> bytes:
    microsec = int(round(1_000_000 / fps)) if fps > 0 else 0
    return struct.pack(
        "<14I", microsec, 0, 0, 0x10, nframes, 0, 1, 0, width, height, 0, 0, 0, 0
    )


def _strh_vids(codec_fourcc: bytes, nframes: int, fps: float) -> bytes:
    scale, rate = 1_000_000, int(round(fps * 1_000_000))
    return struct.pack(
        "<4s4sIIIIIIIIiI8x", b"vids", codec_fourcc, 0, 0, 0,
        scale, rate, 0, nframes, 0, -1, 0,
    )


def _strf_vids(width: int, height: int, bpp: int, codec_fourcc: bytes,
               palette: Optional[bytes]) -> bytes:
    pal = palette or b""
    bi = struct.pack(
        "<IiiHH4sIiiII", 40, width, height, 1, bpp, codec_fourcc,
        width * height * (bpp // 8), 0, 0, len(pal) // 4 if pal else 0, 0,
    )
    return bi + pal


def _strh_auds() -> bytes:
    return struct.pack("<4s4sIIIIIIIIiI8x", b"auds", b"\x00" * 4, 0, 0, 0,
                       1, 44100, 0, 0, 0, -1, 1)


def _strf_auds() -> bytes:
    # WAVEFORMATEX for MP3 (format tag 0x55), minimal
    return struct.pack("<HHIIHH", 0x55, 2, 44100, 16000, 1, 0)


def mux_avi(
    frames: Sequence[bytes],
    width: int,
    height: int,
    bpp: int,
    codec: str = "SPV2",
    fps: float = 15.0,
    palette: Optional[bytes] = None,
    keyflags: Optional[Sequence[bool]] = None,
    sound_chunks: Optional[Sequence[tuple[int, bytes]]] = None,
    with_idx1: bool = True,
) -> bytes:
    """Build a simple (idx1-indexed) AVI file.

    sound_chunks: list of (after_frame_index, payload) '01wb' chunks placed
    after the given video frame inside movi.
    """
    fcc = codec.encode("latin-1")
    if keyflags is None:
        keyflags = [i == 0 for i in range(len(frames))]
    sound_map: dict[int, list[bytes]] = {}
    for after, payload in sound_chunks or []:
        sound_map.setdefault(after, []).append(payload)

    strl_v = _list(b"strl", _chunk(b"strh", _strh_vids(fcc, len(frames), fps))
                   + _chunk(b"strf", _strf_vids(width, height, bpp, fcc, palette)))
    strls = strl_v
    if sound_chunks:
        strls += _list(b"strl", _chunk(b"strh", _strh_auds())
                       + _chunk(b"strf", _strf_auds()))
    hdrl = _list(b"hdrl", _chunk(b"avih", _avih(width, height, len(frames), fps)) + strls)

    # movi body + idx1 entries.  idx1 offsets are relative to the 'movi'
    # fourcc position; dwChunkOffset points at the chunk header
    # (DataLoaderAVIIndexed.hx:302,319-323: base_offset = movi_size_pos + 4).
    movi_body = b""
    idx1_entries = []
    for i, frm in enumerate(frames):
        off = 4 + len(movi_body)  # relative to 'movi' fourcc
        idx1_entries.append(struct.pack("<4sIII", b"00dc",
                                        0x10 if keyflags[i] else 0, off, len(frm)))
        movi_body += _chunk(b"00dc", frm)
        for snd in sound_map.get(i, []):
            off = 4 + len(movi_body)
            idx1_entries.append(struct.pack("<4sIII", b"01wb", 0, off, len(snd)))
            movi_body += _chunk(b"01wb", snd)
    movi = _list(b"movi", movi_body)

    body = hdrl + movi
    if with_idx1:
        body += _chunk(b"idx1", b"".join(idx1_entries))
    return _chunk(b"RIFF", b"AVI " + body)


def mux_avi_opendml(
    frames: Sequence[bytes],
    width: int,
    height: int,
    bpp: int,
    codec: str = "SPV2",
    fps: float = 15.0,
    palette: Optional[bytes] = None,
    keyflags: Optional[Sequence[bool]] = None,
    frames_per_ix: int = 50,
) -> bytes:
    """Build an OpenDML AVI: 'indx' super index in strl pointing at 'ix00'
    std-index chunks embedded in movi (the layout DataLoaderAVIIndexed's
    start_loading_ix / parse_ix consume, DataLoaderAVIIndexed.hx:360-403)."""
    fcc = codec.encode("latin-1")
    if keyflags is None:
        keyflags = [i == 0 for i in range(len(frames))]
    n = len(frames)
    segments = [list(range(s, min(s + frames_per_ix, n)))
                for s in range(0, n, frames_per_ix)]

    # Layout is position-dependent (indx holds absolute ix00 offsets), so
    # compute sizes first with a dry run.
    def build(ix_offsets_abs, movi_data_start):
        movi_body = b""
        ix_positions = []  # absolute pos of each ix00 chunk header
        frame_positions = []  # absolute pos of each frame chunk header
        for seg_i, seg in enumerate(segments):
            for fi in seg:
                frame_positions.append(movi_data_start + len(movi_body))
                movi_body += _chunk(b"00dc", frames[fi])
            # ix00 after the segment's frames
            ix_positions.append(movi_data_start + len(movi_body))
            base = movi_data_start
            entries = b""
            for fi in seg:
                # +8: entry offset points at data; parser subtracts 8
                # (parse_ix, DataLoader.hx:344)
                rel = frame_positions[fi] - base + 8
                sz = len(frames[fi]) | (0 if keyflags[fi] else 0x80000000)
                entries += struct.pack("<II", rel, sz)
            hdr = struct.pack("<HBBI4sII4x", 2, 0, 1, len(seg), b"00dc",
                              base & 0xFFFFFFFF, base >> 32)
            movi_body += _chunk(b"ix00", hdr + entries)
        return movi_body, ix_positions

    def indx_payload(ix_positions):
        hdr = struct.pack("<HBBI4s12x", 4, 0, 0, len(segments), b"00dc")
        body = b""
        for seg_i, seg in enumerate(segments):
            off = ix_positions[seg_i] if ix_positions else 0
            # size includes the 8-byte chunk header region the loader requests
            size = 8 + 24 + 8 * len(seg) + ((24 + 8 * len(seg)) & 1)
            body += struct.pack("<IIII", off & 0xFFFFFFFF, off >> 32, size, len(seg))
        return hdr + body

    # dry run to fix sizes
    dummy_indx = indx_payload([0] * len(segments))
    strl_v = _list(b"strl", _chunk(b"strh", _strh_vids(fcc, n, fps))
                   + _chunk(b"strf", _strf_vids(width, height, bpp, fcc, palette))
                   + _chunk(b"indx", dummy_indx))
    hdrl = _list(b"hdrl", _chunk(b"avih", _avih(width, height, n, fps)) + strl_v)
    riff_header_len = 12  # 'RIFF' size 'AVI '
    movi_data_start = riff_header_len + len(hdrl) + 12  # + LIST size 'movi'
    movi_body, ix_positions = build(None, movi_data_start)
    # real indx with actual positions (same size as dummy by construction)
    indx = indx_payload(ix_positions)
    assert len(indx) == len(dummy_indx)
    strl_v = _list(b"strl", _chunk(b"strh", _strh_vids(fcc, n, fps))
                   + _chunk(b"strf", _strf_vids(width, height, bpp, fcc, palette))
                   + _chunk(b"indx", indx))
    hdrl = _list(b"hdrl", _chunk(b"avih", _avih(width, height, n, fps)) + strl_v)
    movi = _list(b"movi", movi_body)
    return _chunk(b"RIFF", b"AVI " + hdrl + movi)

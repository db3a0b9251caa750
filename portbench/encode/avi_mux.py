"""The AVI muxer, frozen for the benchmark.

A copy of ``mux_avi`` and its helpers from jsplayer_tpu_torch/encode/
avi_mux.py as they stood when the benchmark was defined, so a later change
to the port's muxer cannot move the benchmark's inputs.  One change: the
movi body is joined once from its parts instead of grown by one bytes
concatenation a chunk (quadratic in a 47 MB stream); the bytes are the
same, which portbench/tests/test_portbench_inputs.py checks.
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
    movi_parts: list[bytes] = []
    movi_len = 0
    idx1_entries = []
    for i, frm in enumerate(frames):
        off = 4 + movi_len  # relative to 'movi' fourcc
        idx1_entries.append(struct.pack("<4sIII", b"00dc",
                                        0x10 if keyflags[i] else 0, off, len(frm)))
        movi_parts.append(_chunk(b"00dc", frm))
        movi_len += len(movi_parts[-1])
        for snd in sound_map.get(i, []):
            off = 4 + movi_len
            idx1_entries.append(struct.pack("<4sIII", b"01wb", 0, off, len(snd)))
            movi_parts.append(_chunk(b"01wb", snd))
            movi_len += len(movi_parts[-1])
    movi = _list(b"movi", b"".join(movi_parts))

    body = hdrl + movi
    if with_idx1:
        body += _chunk(b"idx1", b"".join(idx1_entries))
    return _chunk(b"RIFF", b"AVI " + body)

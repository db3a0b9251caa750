"""MSVideo1 (CRAM) 8-bit palettized: the frozen numpy encoder (msv1_enc8.py).

``PALETTE`` is the stream's palette, which the muxer writes after the
BITMAPINFOHEADER in ``strf`` (little-endian u32 quads, as
codecs/msvideo1.palette_to_u32 reads them, MSVideo1.hx:281-291): the 6x6x6
colour cube on steps of 0x33 (index 36r + 6g + b), then 40 greys from 0x08
to 0xF2 in steps of 6, every entry distinct.  The recipe draws palette
indices; the source frames the judge holds are ``PALETTE[indices]``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .msv1_enc8 import encode_frame_8

FOURCC = "CRAM"
BPP = 8
PALETTE = np.array(
    [(0x33 * r << 16) | (0x33 * g << 8) | 0x33 * b
     for r in range(6) for g in range(6) for b in range(6)]
    + [v * 0x010101 for v in range(0x08, 0xF3, 6)], dtype=np.uint32)
assert PALETTE.shape == (256,) and len(np.unique(PALETTE)) == 256


def encode(frames: np.ndarray, keys: Sequence[bool]) -> list[bytes]:
    """frames [n, Y, X] u8 palette indices → n chunks, a keyframe (coded
    without a previous frame) where keys[t]."""
    n, Y, X = frames.shape
    out, prev = [], None
    for f, k in zip(frames, keys):
        flat = f.reshape(-1)
        out.append(encode_frame_8(flat, None if k else prev, X, Y))
        prev = flat
    return out

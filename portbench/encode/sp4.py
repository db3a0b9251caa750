"""ScreenPressor v4, 24-bit: the frozen native encoder (spenc.py)."""

from __future__ import annotations

from typing import Sequence

import numpy as np

from . import spenc

FOURCC = "SPV4"
BPP = 24


def encode(frames: np.ndarray, keys: Sequence[bool]) -> list[bytes]:
    """frames [n, Y, X] u32 → n chunks, an I-frame where keys[t]."""
    n, Y, X = frames.shape
    enc = spenc.Encoder(4, X, Y, BPP)
    try:
        return [enc.encode_i(f) if k else enc.encode_p(f)
                for f, k in zip(frames, keys)]
    finally:
        enc.close()

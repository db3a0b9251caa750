"""MSVideo1 (CRAM) 16-bit: the frozen numpy encoder (msv1_enc.py)."""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .msv1_enc import encode_frame_16

FOURCC = "CRAM"
BPP = 16


def encode(frames: np.ndarray, keys: Sequence[bool]) -> list[bytes]:
    """frames [n, Y, X] u32 on the RGB555 lattice → n chunks, a keyframe
    (coded without a previous frame) where keys[t]."""
    n, Y, X = frames.shape
    out, prev = [], None
    for f, k in zip(frames, keys):
        flat = f.reshape(-1)
        out.append(encode_frame_16(flat, None if k else prev, X, Y))
        prev = flat
    return out

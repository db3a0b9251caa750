"""The msv1_desktop content recipe: MSVideo1 screen-like frames.

A frozen copy of the content of jsplayer_tpu_torch/experiments/
msv1_step.py (``_frames``, with ``from_rgb15`` of codecs/msvideo1.py) as
it stood when the benchmark was defined: a flat desktop, windows of two
colours a 2x2 quadrant opening, moving and repainting, a third of the
frames stills.  Colours lie on the RGB555 lattice, so 16-bit CRAM codes
them losslessly.
"""

from __future__ import annotations

import numpy as np


def from_rgb15(c: int) -> int:
    """RGB555 → packed 0x00RRGGBB (MSVideo1.hx:211-214)."""
    return ((c & 0x1F) << 3) | ((c & 0x3E0) << 6) | ((c & 0x7C00) << 9)


def _frames(rng, bits, T, X, Y):
    """T source frames [Y, X] of one stream: u32 RGB555-lattice words
    (16-bit) or palette indices (8-bit)."""
    qy, qx = np.mgrid[0:Y, 0:X] // 2
    ncol = 12
    if bits == 16:
        pal = np.array([from_rgb15(int(c)) for c in
                        rng.integers(0, 0x8000, ncol)], dtype=np.uint32)
    else:
        pal = rng.choice(256, ncol, replace=False).astype(np.uint8)
    f = np.full((Y, X), pal[0], dtype=pal.dtype)
    out = []
    for t in range(T):
        f = f.copy()
        if t % 3 != 2:  # a window opens or repaints: 2 colours a quadrant
            h, w = (int(rng.integers(2, max(3, Y // 16))) * 4,
                    int(rng.integers(2, max(3, X // 16))) * 4)
            y0 = int(rng.integers(0, (Y - h) // 4 + 1)) * 4
            x0 = int(rng.integers(0, (X - w) // 4 + 1)) * 4
            pair = rng.integers(0, ncol, (Y // 2, X // 2, 2))
            img = pal[pair[qy, qx, rng.integers(0, 2, (Y, X))]]
            f[y0:y0 + h, x0:x0 + w] = img[y0:y0 + h, x0:x0 + w]
        out.append(f)
    return out, pal


def frames(seed: int, n: int, Y: int, X: int, bits: int = 16) -> np.ndarray:
    """n frames [n, Y, X] u32 drawn from `seed` (msv1_step's stream seed):
    RGB555-lattice words (16-bit) or palette indices (8-bit)."""
    out, _ = _frames(np.random.default_rng(seed), bits, n, X, Y)
    return np.stack(out)

"""The video_call content recipe: a desktop hosting a playing video.

A frozen copy of ``video_call`` from jsplayer_tpu_torch/utils/corpora.py
(with ``pack`` and ``_draw_text_line``) as it stood when the benchmark
was defined.  Every frame changes inside the video rect: no stills to
elide, and the entropy stage carries the work.
"""

from __future__ import annotations

import numpy as np


def pack(r, g, b):
    return np.uint32((int(r) << 16) | (int(g) << 8) | int(b))


def _draw_text_line(f, x0, y0, n_chars, rng, fg, bg):
    """Glyph-like blobs: per character a 7x11 cell with random set pixels
    (text has codec-relevant structure: high-contrast small features)."""
    Yf, Xf = f.shape
    for c in range(n_chars):
        cx = x0 + c * 9
        glyph = rng.random((11, 7)) < 0.45
        cell = np.where(glyph, fg, bg).astype(np.uint32)
        # clip to the frame: small test frames would otherwise hit a
        # numpy broadcast error on the final partially-visible glyph
        h, w = min(11, Yf - y0), min(7, Xf - cx)
        if h <= 0 or w <= 0:
            break
        f[y0 : y0 + h, cx : cx + w] = cell[:h, :w]


def video_call(T: int = 120, Y: int = 1080, X: int = 1920, seed: int = 0,
               vw: int = 640, vh: int = 360):
    """Screencast with an embedded PLAYING VIDEO region — the dense end of
    realistic screen content (terminal_session is the sparse end, noise
    the adversarial floor).

    A static desktop (window chrome, text-like rows) hosts a vw x vh
    video rect whose every frame changes: a smoothly-drifting two-axis
    gradient plus sparse camera-noise speckles.  Every frame is
    "changed" (no stills to elide) but the change is rect-local, so
    per-band/sub-frame strategies and the host's rect-shaped capture are
    what this corpus exercises; entropy-wise the gradient is compressible
    while the speckles are not — between the terminal corpus's ~5.5 KB
    and noise's ~8.4 MB per frame.  → list of [Y, X] u32 frames."""
    rng = np.random.default_rng(seed)
    f = np.full((Y, X), pack(28, 30, 36), dtype=np.uint32)
    # desktop dressing: a title bar and a column of text-like lines
    f[0:24, :] = pack(55, 58, 66)
    for i in range(24):
        y0 = 60 + i * 22
        if y0 + 12 < Y:
            _draw_text_line(f, 40, y0, int(rng.integers(20, 70)), rng,
                            pack(205, 205, 210), pack(28, 30, 36))
    vx = (X - vw) // 2
    vy = (Y - vh) // 2
    f[vy - 4 : vy + vh + 4, vx - 4 : vx + vw + 4] = pack(70, 70, 76)
    yy, xx = np.mgrid[0:vh, 0:vw]
    frames = []
    for t in range(T):
        ph = 2 * np.pi * t / 48.0
        r = (128 + 96 * np.sin(xx / 97.0 + ph)).astype(np.uint32)
        g = (128 + 96 * np.cos(yy / 61.0 - ph)).astype(np.uint32)
        b = (128 + 96 * np.sin((xx + yy) / 131.0 + 0.5 * ph)).astype(
            np.uint32)
        vid = (r << 16) | (g << 8) | b
        n_speck = 800
        sy = rng.integers(0, vh, n_speck)
        sx = rng.integers(0, vw, n_speck)
        vid[sy, sx] = rng.integers(0, 1 << 24, n_speck).astype(np.uint32)
        f[vy : vy + vh, vx : vx + vw] = vid
        frames.append(f.copy())
    return frames


def frames(seed: int, n: int, Y: int, X: int, vw: int = 640,
           vh: int = 360) -> np.ndarray:
    """n frames [n, Y, X] u32 of the call drawn from `seed`."""
    return np.stack(video_call(T=n, Y=Y, X=X, seed=seed, vw=vw, vh=vh))

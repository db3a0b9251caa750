"""The terminal_session content recipe: a rendered terminal screencast.

A frozen copy of ``terminal_session`` (with ``pack`` and
``_draw_text_line``) from jsplayer_tpu_torch/utils/corpora.py as it stood
when the benchmark was defined, so a later change to the port's corpora
cannot move the benchmark's inputs.  ``frames`` is the interface every
recipe module gives the input maker (portbench/inputs.py).
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


def terminal_session(T: int = 240, Y: int = 1080, X: int = 1920,
                     seed: int = 0):
    """A rendered terminal screencast: the realistic capture-like corpus.

    Event mix per frame (drawn once, then deterministic):
      ~50% idle (true stills), ~20% typing (a few new glyphs — tiny data
      rects), ~8% cursor blink (one cell), ~14% output scroll (full-width
      16 px line scroll + a new bottom line — motion blocks), ~4% command
      output burst (several new lines), ~2% window repaint/switch, plus a
      cold start that paints the desktop + window chrome.
    → list of [Y, X] u32 frames."""
    rng = np.random.default_rng(seed)
    desk = pack(12, 60, 90)
    win_bg = pack(24, 24, 28)
    fg = pack(200, 220, 200)
    chrome = pack(60, 60, 70)
    # window geometry — clamped so small test frames still get a valid
    # terminal window; bit-identical to the fixed 140/80/1640/920 layout
    # at the standard 1080p capture size
    wx, wy = min(140, X // 8), min(80, Y // 8)
    ww, wh = min(1640, X - wx - 8), min(920, Y - wy - 8)
    f = np.full((Y, X), desk, dtype=np.uint32)
    # desktop icons
    for _ in range(8):
        x0 = int(rng.integers(0, X - 80))
        y0 = int(rng.integers(0, Y - 80))
        f[y0 : y0 + 64, x0 : x0 + 64] = pack(*rng.integers(40, 200, 3))
    f[wy : wy + wh, wx : wx + ww] = win_bg
    f[wy : wy + 24, wx : wx + ww] = chrome  # title bar
    frames = [f.copy()]
    line_h, pad = 16, 10
    tx, ty = wx + pad, wy + 24 + pad            # text origin
    rows = (wh - 24 - 2 * pad) // line_h
    cur_row, cur_col = 0, 0
    cursor_on = False

    def cursor_cell(row, col):
        return (ty + row * line_h, tx + col * 9)

    events = rng.choice(
        ["idle", "type", "blink", "scroll", "burst", "repaint"],
        size=T - 1, p=[0.50, 0.20, 0.08, 0.14, 0.04, 0.04])

    def scroll_up():
        nonlocal cur_row
        top, bot = ty, ty + rows * line_h
        f[top : bot - line_h, tx : tx + ww - 2 * pad] = \
            f[top + line_h : bot, tx : tx + ww - 2 * pad].copy()
        f[bot - line_h : bot, tx : tx + ww - 2 * pad] = win_bg

    def new_line(n_chars):
        nonlocal cur_row, cur_col
        if cur_row >= rows - 1:
            scroll_up()
            cur_row = rows - 1
        _draw_text_line(f, tx, ty + cur_row * line_h, n_chars, rng, fg,
                        win_bg)
        cur_row += 1
        cur_col = 0

    for ev in events:
        if ev == "idle":
            pass
        elif ev == "blink":
            cy, cx = cursor_cell(min(cur_row, rows - 1), cur_col)
            f[cy : cy + 13, cx : cx + 8] ^= np.uint32(0x00FFFFFF)
            cursor_on = not cursor_on
        elif ev == "type":
            n = int(rng.integers(1, 6))
            cy, cx = cursor_cell(min(cur_row, rows - 1), cur_col)
            _draw_text_line(f, cx, cy, n, rng, fg, win_bg)
            cur_col = min(cur_col + n, 170)
        elif ev == "scroll":
            scroll_up()
            _draw_text_line(f, tx, ty + (rows - 1) * line_h,
                            int(rng.integers(10, 120)), rng, fg, win_bg)
        elif ev == "burst":
            for _ in range(int(rng.integers(3, 8))):
                new_line(int(rng.integers(5, 140)))
        else:  # repaint: window content switches wholesale
            f[wy + 24 : wy + wh, wx : wx + ww] = win_bg
            cur_row, cur_col = 0, 0
            for _ in range(int(rng.integers(4, max(5, rows // 2)))):
                new_line(int(rng.integers(10, 140)))
        frames.append(f.copy())
    return frames


def frames(seed: int, n: int, Y: int, X: int) -> np.ndarray:
    """n frames [n, Y, X] u32 of the session drawn from `seed`."""
    return np.stack(terminal_session(T=n, Y=Y, X=X, seed=seed))

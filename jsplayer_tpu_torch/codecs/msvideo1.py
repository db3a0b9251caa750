"""MSVideo1 (CRAM) decoder — host oracle + device-command parser.

Bit-exact Python/NumPy re-implementation of the reference decoder
(MSVideo1.hx:8-429).  This module is the *executable spec*: the TPU paint
kernel (kernels/msv1_paint.py) must match it exactly.

Layout: frames are flat ``np.uint32[X*Y]`` pixel arrays in file order
(bottom-up rows, as stored in AVI; the reference displays them with a
negative-Y matrix, Main.hx:318).  Pixels are packed 0x00RRGGBB via
``from_rgb15`` (MSVideo1.hx:211-219) or the 8-bit palette u32s
(MSVideo1.hx:281-291).

Known deviations from reference JS edge-behavior (documented, not bugs):
  * a truncated/malformed stream stops decoding and leaves the remaining
    blocks as prev-frame copies (the reference's JS would read ``undefined``
    past the buffer end and paint black; that path is unreachable for
    well-formed streams, which are the parity domain);
  * an empty 8-bit P-frame returns "no change" like the 16-bit path
    (MSVideo1.hx:109) instead of reading past the empty buffer.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .base import DecoderState, PFrameResult, VideoCodec


def from_rgb15(c: int) -> int:
    """RGB555 → packed 0x00RRGGBB (MSVideo1.hx:211-214)."""
    return ((c & 0x1F) << 3) | ((c & 0x3E0) << 6) | ((c & 0x7C00) << 9)


def palette_to_u32(pal8: bytes) -> np.ndarray:
    """8-bit palette bytes → 256 u32 entries (MSVideo1_8bit.Preinit,
    MSVideo1.hx:281-291: little-endian u32 quads)."""
    pal = np.zeros(256, dtype=np.uint32)
    n = min(256, len(pal8) // 4)
    if n:
        pal[:n] = np.frombuffer(pal8[: n * 4], dtype="<u4")
    return pal


class _Truncated(Exception):
    pass


class _Reader:
    __slots__ = ("d", "si", "n")

    def __init__(self, d: bytes):
        self.d = d
        self.si = 0
        self.n = len(d)

    def u8(self) -> int:
        if self.si >= self.n:
            raise _Truncated
        v = self.d[self.si]
        self.si += 1
        return v

    def u16le(self) -> int:
        if self.si + 2 > self.n:
            raise _Truncated
        v = self.d[self.si] | (self.d[self.si + 1] << 8)
        self.si += 2
        return v


# Per-pixel bit index: paint order is x inner, y outer (MSVideo1.hx:150-168)
_PIX_Y = np.repeat(np.arange(4), 4)
_PIX_X = np.tile(np.arange(4), 4)
# 8-color quadrant base: ty + (x&2)  (MSVideo1.hx:151-154)
_QUAD = (((_PIX_Y & 2) << 1) + (_PIX_X & 2)).astype(np.uint8)


class MSVideo1_16bit(VideoCodec):
    """MSVideo1 16-bit decoder (MSVideo1.hx:8-260)."""

    def __init__(self, width: int, height: int):
        self.X = width
        self.Y = height
        self.nbx = width >> 2
        self.nby = height >> 2
        self.block_changes = np.zeros(self.nby, dtype=bool)
        self.insignificant_blocks = 0
        self.insign_lines = 0
        self.prev: Optional[np.ndarray] = None
        nblocks = self.nbx * self.nby
        # JustSkipBlocks fast-path threshold (MSVideo1.hx:30)
        self.size_of_just_skips = (nblocks // 1023) * 2 + 10

    # -- IVideoCodec surface -------------------------------------------------

    def preinit(self, insignificant_lines: int) -> None:
        # MSVideo1.hx:37-41
        self.insignificant_blocks = (insignificant_lines + 3) >> 2
        self.insign_lines = insignificant_lines

    def previous_frame(self) -> Optional[np.ndarray]:
        return self.prev

    def needs_index(self) -> bool:
        return True  # MSVideo1.hx:221-224

    def decompress_i(self, src: bytes, dst: np.ndarray) -> DecoderState:
        # MSVideo1.hx:62-67: I == P for CRAM
        self.decompress_p(src, dst)
        return DecoderState.ZERO

    # -- core ----------------------------------------------------------------

    def _just_skip_blocks(self, src: bytes) -> bool:
        # MSVideo1.hx:86-104
        si, n = 0, 0
        nblocks = self.nbx * self.nby
        while si < len(src) - 1:
            a, b = src[si], src[si + 1]
            if (b & 0xFC) == 0x84:
                n += ((b - 0x84) << 8) + a
                if n >= nblocks:
                    return True
            else:
                return False
            si += 2
        return True

    def _block_view(self, frame: np.ndarray, by: int, bx: int) -> np.ndarray:
        X = self.X
        base = by * 4 * X + bx * 4
        idx = base + _PIX_Y * X + _PIX_X
        return idx

    def decompress_p(self, src: bytes, dst: np.ndarray) -> PFrameResult:
        # MSVideo1.hx:106-209
        if len(src) == 0 or (
            len(src) < self.size_of_just_skips and self._just_skip_blocks(src)
        ):
            return PFrameResult(self.prev, False)
        r = _Reader(src)
        skip = 0
        changes = False
        self.block_changes[:] = False
        prev = self.prev
        # Unvisited/skip blocks read as prev content.  (The reference copies
        # skip blocks one by one, MSVideo1.hx:74-84, and leaves blocks after
        # a truncation as stale buffer content — a latent quirk unreachable
        # for well-formed streams; we define them as prev-copies, which is
        # identical for full-coverage streams and what the device kernel does.)
        if prev is not None:
            np.copyto(dst, prev)
        try:
            for by in range(self.nby):
                for bx in range(self.nbx):
                    if skip:
                        skip -= 1
                        continue
                    idx = self._block_view(dst, by, bx)
                    a = r.u8()
                    b = r.u8()
                    if (b & 0xFC) == 0x84:
                        skip = ((b - 0x84) << 8) + a - 1
                    elif b < 0x80:
                        flags = ((b << 8) + a) ^ 0xFFFF
                        bits = (flags >> np.arange(16)) & 1
                        clr0 = r.u16le()
                        c1 = r.u16le()
                        if clr0 & 0x8000:
                            pal = np.array(
                                [from_rgb15(clr0), from_rgb15(c1)]
                                + [from_rgb15(r.u16le()) for _ in range(6)],
                                dtype=np.uint32,
                            )
                            sel = _QUAD + bits.astype(np.uint8)
                        else:
                            pal = np.array(
                                [from_rgb15(clr0), from_rgb15(c1)], dtype=np.uint32
                            )
                            sel = bits.astype(np.uint8)
                        dst[idx] = pal[sel]
                        changes = True
                        self.block_changes[by] = True
                    else:
                        clr = from_rgb15((b << 8) + a)
                        dst[idx] = clr
                        changes = True
                        self.block_changes[by] = True
        except _Truncated:
            pass
        return self._finish(dst, changes)

    def _finish(self, dst: np.ndarray, changes: bool) -> PFrameResult:
        # significant-change verdict (MSVideo1.hx:187-208)
        signif = False
        if changes:
            signif = bool(self.block_changes[self.insignificant_blocks :].any())
        if signif and self.prev is not None:
            lo = self.insign_lines * self.X
            signif = bool((dst[lo:] != self.prev[lo:]).any())
        if changes:
            self.prev = dst
        return PFrameResult(self.prev, signif)

    def is_key_frame(self, src: bytes) -> bool:
        # MSVideo1.hx:226-259
        if len(src) == 0:
            return False
        r = _Reader(src)
        skip = 0
        try:
            for _ in range(self.nby * self.nbx):
                if skip:
                    skip -= 1
                    continue
                a = r.u8()
                b = r.u8()
                if (b & 0xFC) == 0x84:
                    return False
                if b < 0x80:
                    clr0 = r.u16le()
                    r.si += 14 if clr0 & 0x8000 else 2
        except _Truncated:
            pass
        return True


class MSVideo1_8bit(MSVideo1_16bit):
    """MSVideo1 8-bit palettized decoder (MSVideo1.hx:262-429)."""

    def __init__(self, width: int, height: int, palette: bytes):
        super().__init__(width, height)
        self.pal = palette_to_u32(palette)

    def preinit(self, insignificant_lines: int) -> None:
        # MSVideo1.hx:281-291 — note: insign_lines deliberately NOT set,
        # preserving the reference quirk (pixel compare starts at line 0)
        self.insignificant_blocks = (insignificant_lines + 3) >> 2

    def decompress_p(self, src: bytes, dst: np.ndarray) -> PFrameResult:
        # MSVideo1.hx:293-393
        if len(src) == 0:
            return PFrameResult(self.prev, False)  # documented deviation
        r = _Reader(src)
        pal = self.pal
        skip = 0
        changes = False
        self.block_changes[:] = False
        prev = self.prev
        if prev is not None:
            np.copyto(dst, prev)  # see 16-bit note on skip/unvisited blocks
        try:
            for by in range(self.nby):
                for bx in range(self.nbx):
                    if skip:
                        skip -= 1
                        continue
                    idx = self._block_view(dst, by, bx)
                    a = r.u8()
                    b = r.u8()
                    if a + b == 0:
                        raise _Truncated  # stream terminator (MSVideo1.hx:313)
                    if (b & 0xFC) == 0x84:
                        skip = ((b - 0x84) << 8) + a - 1
                    elif b < 0x80:
                        flags = (b << 8) + a  # NOT inverted (MSVideo1.hx:320)
                        bits = (flags >> np.arange(16)) & 1
                        # p2[1]=pal[src[si]]; p2[0]=pal[src[si+1]] (:322-323)
                        c1 = r.u8()
                        c0 = r.u8()
                        p2 = np.array([pal[c0], pal[c1]], dtype=np.uint32)
                        dst[idx] = p2[bits]
                        changes = True
                        self.block_changes[by] = True
                    elif b >= 0x90:
                        flags = ((b << 8) + a) ^ 0xFFFF
                        bits = (flags >> np.arange(16)) & 1
                        p2 = np.array([pal[r.u8()] for _ in range(8)], dtype=np.uint32)
                        sel = _QUAD + bits.astype(np.uint8)
                        dst[idx] = p2[sel]
                        changes = True
                        self.block_changes[by] = True
                    else:
                        dst[idx] = pal[a]
                        changes = True
                        self.block_changes[by] = True
        except _Truncated:
            pass
        return self._finish(dst, changes)

    def is_key_frame(self, src: bytes) -> bool:
        # MSVideo1.hx:395-427
        if len(src) == 0:
            return False
        r = _Reader(src)
        skip = 0
        key = True
        try:
            for _ in range(self.nby * self.nbx):
                if skip:
                    skip -= 1
                    continue
                a = r.u8()
                b = r.u8()
                if a + b == 0:
                    raise _Truncated
                if (b & 0xFC) == 0x84:
                    skip = ((b - 0x84) << 8) + a - 1
                    key = False
                elif b < 0x80:
                    r.si += 2
                elif b >= 0x90:
                    r.si += 8
        except _Truncated:
            pass
        return key


# ---------------------------------------------------------------------------
# Device-command parser: opcode stream → dense per-block command tensors.
# The TPU kernel consumes (block_type, sel, colors); see kernels/msv1_paint.py.
# ---------------------------------------------------------------------------

BLOCK_COPY = 0
BLOCK_PAINT = 1


def parse_commands(
    src: bytes, X: int, Y: int, pal: Optional[np.ndarray] = None
) -> tuple[np.ndarray, np.ndarray, np.ndarray, bool]:
    """Parse one MSV1 frame into dense command tensors.

    Returns (block_type[NB] u8, sel[NB,16] u8, colors[NB,8] u32, changes).
    ``pal`` selects the 8-bit variant (256-entry u32 palette); None = 16-bit.
    Block order is row-major (by, bx) over 4×4 blocks, identical to the
    decode loop (MSVideo1.hx:120-185).
    """
    nbx, nby = X >> 2, Y >> 2
    nb = nbx * nby
    btype = np.zeros(nb, dtype=np.uint8)
    sel = np.zeros((nb, 16), dtype=np.uint8)
    colors = np.zeros((nb, 8), dtype=np.uint32)
    changes = False
    if len(src) == 0:
        return btype, sel, colors, changes
    r = _Reader(src)
    is8 = pal is not None
    bi = 0
    skip = 0
    bitpos = np.arange(16)
    try:
        while bi < nb:
            if skip:
                take = min(skip, nb - bi)
                skip -= take
                bi += take
                continue
            a = r.u8()
            b = r.u8()
            if is8 and a + b == 0:
                break
            if (b & 0xFC) == 0x84:
                skip = ((b - 0x84) << 8) + a
                continue
            if b < 0x80:
                if is8:
                    flags = (b << 8) + a
                    bits = ((flags >> bitpos) & 1).astype(np.uint8)
                    c1 = r.u8()
                    c0 = r.u8()
                    colors[bi, 0] = pal[c0]
                    colors[bi, 1] = pal[c1]
                    sel[bi] = bits
                else:
                    flags = ((b << 8) + a) ^ 0xFFFF
                    bits = ((flags >> bitpos) & 1).astype(np.uint8)
                    clr0 = r.u16le()
                    c1 = r.u16le()
                    if clr0 & 0x8000:
                        colors[bi, 0] = from_rgb15(clr0)
                        colors[bi, 1] = from_rgb15(c1)
                        for k in range(2, 8):
                            colors[bi, k] = from_rgb15(r.u16le())
                        sel[bi] = _QUAD + bits
                    else:
                        colors[bi, 0] = from_rgb15(clr0)
                        colors[bi, 1] = from_rgb15(c1)
                        sel[bi] = bits
                btype[bi] = BLOCK_PAINT
                changes = True
            elif is8 and b >= 0x90:
                flags = ((b << 8) + a) ^ 0xFFFF
                bits = ((flags >> bitpos) & 1).astype(np.uint8)
                for k in range(8):
                    colors[bi, k] = pal[r.u8()]
                sel[bi] = _QUAD + bits
                btype[bi] = BLOCK_PAINT
                changes = True
            else:
                colors[bi, 0] = pal[a] if is8 else from_rgb15((b << 8) + a)
                btype[bi] = BLOCK_PAINT
                changes = True
            bi += 1
    except _Truncated:
        pass
    return btype, sel, colors, changes

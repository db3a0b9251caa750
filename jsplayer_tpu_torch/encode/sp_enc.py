"""ScreenPressor v2/v3/v4 encoder — fixture/stream generator.

The reference is decode-only; this encoder emits streams whose decode
semantics are fixed by the reference decoder (ScreenPressor.hx:117-484) and
our oracle (codecs/screenpressor.py).  It drives the paired entropy encoder
facades (codecs/entropy.py), whose adaptive state mirrors the decoder's
exactly, so encode→decode is a bit-exact round trip.

Correctness strategy: the encoder maintains ``sim``, a replica of the
decoder's dst buffer, and only selects a predictor when the prediction
computed *from sim* equals the target pixel — reproducing the decoder's
read-order semantics (including reads of not-yet-processed positions, which
hold prev-frame content in our decode model).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..codecs.entropy import (
    EntroEncoderANS,
    EntroEncoderRC,
    MSR_X,
    MSR_Y,
)


def pack_rgb(r: int, g: int, b: int) -> int:
    """Pixel packing used by the decode loop (ScreenPressor.hx:189)."""
    return (b << 16) | (g << 8) | r


def _grad(L: int, U1: int, U0: int) -> int:
    r = (L & 0xFF) + (U1 & 0xFF) - (U0 & 0xFF)
    g = ((L >> 8) & 0xFF) + ((U1 >> 8) & 0xFF) - ((U0 >> 8) & 0xFF)
    b = ((L >> 16) & 0xFF) + ((U1 >> 16) & 0xFF) - ((U0 >> 16) & 0xFF)
    return ((b & 0xFF) << 16) | ((g & 0xFF) << 8) | (r & 0xFF)


DEFAULT_MOTION_CANDIDATES = [
    (0, -1), (0, 1), (-1, 0), (1, 0), (-1, -1), (1, 1), (1, -1), (-1, 1),
    (0, -2), (0, 2), (-2, 0), (2, 0), (0, -4), (4, 0), (-4, 0), (0, 4),
    (0, -8), (8, 0), (-8, 0), (0, 8),
    # appended round 3 (order-preserving: earlier outputs unchanged):
    # line-height scrolls (text UIs scroll by 12-16 px) and 3 px nudges
    (0, -16), (0, 16), (-16, 0), (16, 0), (0, -12), (0, 12),
    (0, -3), (0, 3), (-3, 0), (3, 0),
]


class ScreenPressorEncoder:
    def __init__(self, version: int, width: int, height: int, bpp: int = 24,
                 motion_candidates: Optional[Sequence[tuple[int, int]]] = None):
        assert version in (2, 3, 4)
        self.version = version
        self.X = width
        self.Y = height
        self.bpp = bpp
        if version == 2:
            self.ec = EntroEncoderRC()
            self.sc_cxshift = 0 if bpp == 16 else 2
        else:
            self.ec = EntroEncoderANS(64 if version == 3 else 32)
            self.sc_cxshift = 2
        self.ec.preinit()
        self.nbx = (width + 15) // 16
        self.nby = (height + 15) // 16
        self.last_flat: Optional[int] = None
        self.prev: Optional[np.ndarray] = None
        self.cx = 0
        self.cx1 = 0
        self.motion_candidates = list(motion_candidates or DEFAULT_MOTION_CANDIDATES)

    # -- helpers -------------------------------------------------------------

    def _cx_consts(self) -> tuple[int, int, int]:
        if self.bpp == 16 and self.ec.different_constants_for_16bpp():
            return 0xFF00, 2, 16
        return 0xFC00, 4, 18

    def _encode_rgb(self, clr: int) -> None:
        """Mirror of the decoder's decodeClr×3 chain (ScreenPressor._decode_rgb)."""
        ec = self.ec
        sh = self.sc_cxshift
        r = clr & 0xFF
        g = (clr >> 8) & 0xFF
        b = (clr >> 16) & 0xFF
        ec.encode_clr(self.cx + self.cx1, r)
        self.cx1 = (self.cx << 6) & 0xFC0
        self.cx = r >> sh
        ec.encode_clr(4096 + self.cx + self.cx1, g)
        self.cx1 = (self.cx << 6) & 0xFC0
        self.cx = g >> sh
        ec.encode_clr(2 * 4096 + self.cx + self.cx1, b)
        self.cx1 = (self.cx << 6) & 0xFC0
        self.cx = b >> sh

    def _head(self, frame_kind: int) -> int:
        return ((self.version - 1) << 4) | frame_kind

    # -- flat I-frame (ScreenPressor.hx:131-155) ------------------------------

    def encode_flat(self, clr: int) -> bytes:
        """clr packed (b<<16)|(g<<8)|r for 24/32bpp."""
        if self.last_flat is None:
            self.ec.renew_i()
        if self.bpp == 16:
            raise NotImplementedError(
                "16bpp flat frames share the head byte with the color "
                "(ScreenPressor.hx:136) — not representable for arbitrary clr"
            )
        head = self._head(1)
        b = (clr >> 16) & 0xFF
        g = (clr >> 8) & 0xFF
        r = clr & 0xFF
        # decoder reads bytes 1..3 as (b,g,r) and packs (r<<16)+(g<<8)+b
        # (ScreenPressor.hx:142-146) — emitting [r,g,b] therefore decodes to
        # (b<<16)|(g<<8)|r == clr, i.e. the coded-loop packing.
        data = bytes([head, r, g, b])
        self.prev = np.full(self.X * self.Y, clr, dtype=np.uint32)
        self.last_flat = clr
        return data

    # -- coded I-frame --------------------------------------------------------

    def encode_i(self, frame: np.ndarray) -> bytes:
        """frame: u32[X*Y] packed (b<<16)|(g<<8)|r."""
        X, Y = self.X, self.Y
        end = X * Y
        f = frame
        self.last_flat = None
        self.ec.renew_i()
        self.ec.begin_frame()
        ec = self.ec
        self.cx = self.cx1 = 0

        di = 0
        k = 0
        while k < X + 1:
            clr = int(f[di])
            n = 1
            while n < 255 and di + n < end and f[di + n] == clr:
                n += 1
            self._encode_rgb(clr)
            ec.encode_n(0, n)
            k += n
            di += n

        maskcx1, shiftcx1, shiftcx = self._cx_consts()
        ptype = 0
        while di < end:
            # candidate run lengths for each predictor at di (lasti == di-1)
            best_p, best_n = 0, 0
            for p in (1, 2, 4, 5):
                n = self._run_len_i(f, di, p, end)
                if n > best_n:
                    best_p, best_n = p, n
            if best_n == 0:
                best_p = 0
                clr = int(f[di])
                best_n = 1
                while best_n < 255 and di + best_n < end and f[di + best_n] == clr:
                    best_n += 1
            ec.encode_p(ptype, best_p)
            ptype = best_p
            if best_p == 0:
                self._encode_rgb(int(f[di]))
            ec.encode_n(best_p, best_n)
            di += best_n
            clr = int(f[di - 1])
            self.cx1 = (clr & maskcx1) >> shiftcx1
            self.cx = clr >> shiftcx

        self.prev = f.copy()
        head = bytes([self._head(2)])
        return head + ec.end_frame()

    def _run_len_i(self, f: np.ndarray, di: int, p: int, end: int) -> int:
        X = self.X
        n = 0
        while n < 255 and di + n < end:
            pos = di + n
            if p == 1:
                pred = int(f[pos - 1])
            elif p == 2:
                pred = int(f[pos - X])
            elif p == 5:
                pred = int(f[pos - X - 1])
            else:  # 4
                pred = _grad(int(f[pos - 1]), int(f[pos - X]), int(f[pos - X - 1]))
            if int(f[pos]) != pred:
                break
            n += 1
        return n

    # -- P-frame --------------------------------------------------------------

    def encode_p(self, cur: np.ndarray) -> bytes:
        """cur: u32[X*Y]; requires a previous frame (encode_i/encode_flat)."""
        assert self.prev is not None
        X, Y = self.X, self.Y
        prev = self.prev
        c2 = cur.reshape(Y, X)
        p2 = prev.reshape(Y, X)

        # block analysis
        nb = self.nbx * self.nby
        bts = np.zeros(nb, dtype=np.int32)
        plans: dict[int, dict] = {}
        for by in range(self.nby):
            for bx in range(self.nbx):
                bi = by * self.nbx + bx
                x16, y16 = bx * 16, by * 16
                bx2, by2 = min(x16 + 16, X), min(y16 + 16, Y)
                blk_c = c2[y16:by2, x16:bx2]
                blk_p = p2[y16:by2, x16:bx2]
                diff = blk_c != blk_p
                if not diff.any():
                    continue
                ys, xs = np.nonzero(diff)
                ry1, ry2 = y16 + int(ys.min()), y16 + int(ys.max()) + 1
                rx1, rx2 = x16 + int(xs.min()), x16 + int(xs.max()) + 1
                # subrect usable iff strictly smaller than the cropped block
                # and representable (sxy symbols are 0..15)
                use_sub = (ry2 - ry1) * (rx2 - rx1) < (by2 - y16) * (bx2 - x16)
                # prefer FULL-BLOCK motion (bts 3) even when the dirty rect
                # is smaller: scrolled text has sparse diffs but the whole
                # block moved, and bts 3 skips the 4 sxy symbols per block
                # (~40% of the terminal-corpus host stage's symbol decodes).
                # Native twin (spdec.cpp SpEncoder) matches byte-for-byte.
                mv_full = (self._find_motion(c2, p2, x16, y16, bx2, by2)
                           if use_sub else None)
                if mv_full is not None:
                    use_sub = False
                    x1, y1, x2, y2 = x16, y16, bx2, by2
                    mv = mv_full
                else:
                    if use_sub:
                        x1, y1, x2, y2 = rx1, ry1, rx2, ry2
                    else:
                        x1, y1, x2, y2 = x16, y16, bx2, by2
                    mv = self._find_motion(c2, p2, x1, y1, x2, y2)
                bits = (1 if use_sub else 0) | (2 if mv is not None else 0)
                bts[bi] = 1 + bits
                plans[bi] = dict(x1=x1, y1=y1, x2=x2, y2=y2, mv=mv,
                                 x16=x16, y16=y16)

        if not bts.any():
            return b"\x00"  # "no changes" head byte (ScreenPressor.hx:311-313)

        ec = self.ec
        self.last_flat = None
        ec.begin_frame()
        nz = np.nonzero(bts)[0]
        xx1, xx2 = int(nz[0]), int(nz[-1])
        ec.encode_x(xx1 & 0xFF)
        ec.encode_x(xx1 >> 8)
        ec.encode_x(xx2 & 0xFF)
        ec.encode_x(xx2 >> 8)
        # block-type runs over [xx1, xx2]
        x = xx1
        while x <= xx2:
            bt = int(bts[x])
            n = 1
            while x + n <= xx2 and int(bts[x + n]) == bt and n < 255:
                n += 1
            ec.encode_bt(bt)
            ec.encode_bn(n)
            x += n

        # per-block payloads over a decoder-state simulation buffer
        sim = prev.copy()
        s2 = sim.reshape(Y, X)
        maskcx1, shiftcx1, shiftcx = self._cx_consts()
        self.cx = self.cx1 = 0
        lastmx = lastmy = 0
        can_bool = self.ec.can_bool()
        for by in range(self.nby):
            for bx in range(self.nbx):
                bi = by * self.nbx + bx
                if bts[bi] <= 0:
                    continue
                pl = plans[bi]
                x1, y1, x2, y2 = pl["x1"], pl["y1"], pl["x2"], pl["y2"]
                if (bts[bi] - 1) & 1:
                    ec.encode_sxy(0, x1 - pl["x16"])
                    ec.encode_sxy(1, y1 - pl["y16"])
                    ec.encode_sxy(2, x2 - pl["x16"] - 1)
                    ec.encode_sxy(3, y2 - pl["y16"] - 1)
                if (bts[bi] - 1) & 2:
                    mx, my = pl["mv"]
                    if can_bool:
                        same = (mx, my) == (lastmx, lastmy)
                        ec.encode_bool(same)
                        if not same:
                            ec.encode_mx(mx + MSR_X)
                            ec.encode_my(my + MSR_Y)
                    else:
                        ec.encode_mx(mx + MSR_X)
                        ec.encode_my(my + MSR_Y)
                    lastmx, lastmy = mx, my
                    s2[y1:y2, x1:x2] = p2[y1 + my : y2 + my, x1 + mx : x2 + mx]
                else:
                    self._encode_data_rect(cur, prev, sim, x1, y1, x2, y2,
                                           maskcx1, shiftcx1, shiftcx)

        self.prev = cur.copy()
        return bytes([1]) + ec.end_frame()

    def _find_motion(self, c2, p2, x1, y1, x2, y2) -> Optional[tuple[int, int]]:
        X, Y = self.X, self.Y
        target = c2[y1:y2, x1:x2]
        for mx, my in self.motion_candidates:
            if (mx, my) == (0, 0):
                continue
            if y1 + my < 0 or y2 + my > Y or x1 + mx < 0 or x2 + mx > X:
                continue
            if (p2[y1 + my : y2 + my, x1 + mx : x2 + mx] == target).all():
                return (mx, my)
        return None

    def _encode_data_rect(self, cur, prev, sim, x1, y1, x2, y2,
                          maskcx1, shiftcx1, shiftcx) -> None:
        """Mirror of the decoder's data-block rect traversal
        (ScreenPressor.hx:406-467), predictions computed from sim."""
        X = self.X
        ec = self.ec
        off = -X - 1
        positions = [(y * X + x) for y in range(y1, y2) for x in range(x1, x2)]
        npos = len(positions)
        k = 0
        ptype = 0
        while k < npos:
            best_p, best_n = 0, 0
            for p in (1, 2, 3, 4, 5):
                n = self._run_len_p(cur, prev, sim, positions, k, p,
                                    (x1, y1, x2, y2))
                if n > best_n:
                    best_p, best_n = p, n
            if best_n == 0:
                best_p = 0
                clr = int(cur[positions[k]])
                best_n = 1
                while (best_n < 255 and k + best_n < npos
                       and int(cur[positions[k + best_n]]) == clr):
                    best_n += 1
            ec.encode_p(ptype, best_p)
            ptype = best_p
            if best_p == 0:
                self._encode_rgb(int(cur[positions[k]]))
            ec.encode_n(best_p, best_n)
            for j in range(k, k + best_n):
                sim[positions[j]] = cur[positions[j]]
            k += best_n
            clr = int(cur[positions[k - 1]])
            self.cx1 = (clr & maskcx1) >> shiftcx1
            self.cx = clr >> shiftcx

    def _run_len_p(self, cur, prev, sim, positions, k, p, rect) -> int:
        """Longest run of predictor p starting at rect-ordinal k.  Reads must
        see the decoder's dst state *mid-run*: positions [k, k+n) of this rect
        hypothetically hold cur values (a run spanning rect rows reads pixels
        written earlier in the same run, ScreenPressor.hx:438-461)."""
        X = self.X
        off = -X - 1
        x1, y1, x2, y2 = rect
        w = x2 - x1

        def read(pos: int, n: int) -> int:
            # overlay: rect positions with ordinal in [k, k+n) read as cur
            y, x = divmod(pos, X)
            if y1 <= y < y2 and x1 <= x < x2:
                o = (y - y1) * w + (x - x1)
                if k <= o < k + n:
                    return int(cur[pos])
            return int(sim[pos])

        n = 0
        npos = len(positions)
        while n < 255 and k + n < npos:
            i = positions[k + n]
            if p == 1:
                if i - 1 < 0:
                    break
                pred = read(i - 1, n)
            elif p == 2:
                if i + off + 1 < 0:
                    break
                pred = read(i + off + 1, n)
            elif p == 3:
                pred = int(prev[i])
            elif p == 4:
                if i - 1 < 0 or i + off < 0:
                    break
                pred = _grad(read(i - 1, n), read(i + off + 1, n), read(i + off, n))
            else:  # 5
                if i + off < 0:
                    break
                pred = read(i + off, n)
            if int(cur[i]) != pred:
                break
            n += 1
        return n

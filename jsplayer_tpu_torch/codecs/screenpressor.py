"""ScreenPressor v2/v3/v4 decoder — host oracle (executable spec).

Bit-exact re-implementation of the reference decoder (ScreenPressor.hx:19-490)
over the entropy facades (codecs/entropy.py).  Pixels are packed
``(b<<16)|(g<<8)|r`` as the decode loop produces them (ScreenPressor.hx:189).

Decode model parity notes:
  * I-frames: flat-fill (head nibble 1, ScreenPressor.hx:131-155 — including
    the 16bpp quirk where the flat color shares byte 0 with the header) or
    context-modeled first-row + predictor-run main loop (:164-286);
  * P-frames: 16×16 block map runs (:331-344), block kinds from the 2-bit
    (bts-1) field: bit0 = subrect, bit1 = motion; data blocks use the 6
    predictor types with rect-wrapping runs (:406-467);
  * the incremental-I ``ContinueI`` path is a one-shot here — the reference's
    slicing logic is commented out and redoes the frame anyway
    (ScreenPressor.hx:210-215, 277-285, SURVEY.md §5.4);
  * consecutive flat frames skip the entropy-table renew
    (RenewI, ScreenPressor.hx:108-115) — irrelevant for table state since
    flat frames never touch the coder, mirrored anyway;
  * significant-change verdict is block-map-based only (:346-352).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .base import DecoderState, PFrameResult, VideoCodec
from .entropy import EntroCoderANS, EntroCoderRC, MSR_X, MSR_Y

I_HEAD_BYTES = (0x12, 0x11, 0x22, 0x21, 0x32, 0x31)  # ScreenPressor.hx:96-101


class ScreenPressor(VideoCodec):
    def __init__(self, width: int, height: int, bits_per_pixel: int = 24):
        # ScreenPressor.hx:53-64
        self.X = width
        self.Y = height
        self.bpp = bits_per_pixel
        self.sc_cxshift = 0 if bits_per_pixel == 16 else 2
        self.nbx = (width + 15) // 16
        self.nby = (height + 15) // 16
        self.bts = np.zeros(self.nbx * self.nby, dtype=np.int32)
        self.prev: Optional[np.ndarray] = None
        self.ec = None
        self.decoding_bools = False
        self.decoded_i = False
        self.last_one_was_flat: Optional[int] = None
        self.insignificant_blocks = 0
        self.cx = 0
        self.cx1 = 0
        # Optional command capture for the device recon kernel
        # (kernels/sp_recon.py): when set to a dict by the caller before a
        # decompress call, it is filled with bts/mv/rect command tensors.
        self.capture: Optional[dict] = None

    # -- IVideoCodec surface -------------------------------------------------

    def preinit(self, insignificant_lines: int) -> None:
        # ScreenPressor.hx:86-89
        self.insignificant_blocks = self.nbx * ((insignificant_lines + 15) // 16)

    def previous_frame(self) -> Optional[np.ndarray]:
        return self.prev

    def is_key_frame(self, data: bytes) -> bool:
        if not data:
            return False
        return data[0] in I_HEAD_BYTES

    def needs_index(self) -> bool:
        return False  # ScreenPressor.hx:486-489

    def _init_entro(self, version: int) -> bool:
        # ScreenPressor.hx:66-79
        if version == 2:
            self.ec = EntroCoderRC()
        elif version == 3:
            self.ec = EntroCoderANS(64)
            self.sc_cxshift = 2
        elif version == 4:
            self.ec = EntroCoderANS(32)
            self.sc_cxshift = 2
        else:
            return False
        self.decoding_bools = self.ec.can_decode_bool()
        self.ec.preinit()
        return True

    def _renew_i(self) -> None:
        # ScreenPressor.hx:108-115
        self.prev = None
        if self.last_one_was_flat is not None:
            return
        self.ec.renew_i()

    def _cx_consts(self) -> tuple[int, int, int]:
        # ScreenPressor.hx:122,200-203,315-318
        if self.bpp == 16 and self.ec.different_constants_for_16bpp():
            return 0xFF00, 2, 16
        return 0xFC00, 4, 18

    def _decode_rgb(self) -> int:
        """The decodeClr ×3 chain with context updates
        (ScreenPressor.hx:173-189, 224-235, 419-430)."""
        ec = self.ec
        sh = self.sc_cxshift
        r = ec.decode_clr(self.cx + self.cx1)
        self.cx1 = (self.cx << 6) & 0xFC0
        self.cx = r >> sh
        g = ec.decode_clr(4096 + self.cx + self.cx1)
        self.cx1 = (self.cx << 6) & 0xFC0
        self.cx = g >> sh
        b = ec.decode_clr(2 * 4096 + self.cx + self.cx1)
        self.cx1 = (self.cx << 6) & 0xFC0
        self.cx = b >> sh
        return (b << 16) | (g << 8) | r

    def _capture_nochange(self) -> None:
        nb = self.nbx * self.nby
        self.capture.update(
            bts=np.zeros(nb, dtype=np.int32),
            mv=np.zeros((nb, 2), dtype=np.int32),
            rect=np.zeros((nb, 4), dtype=np.int32),
            changed=False,
        )

    def _capture_full_data(self) -> None:
        """I-frame (coded or flat) as device commands: every block is a
        full-rect data block; payload (the decoded dst) covers the frame."""
        nb = self.nbx * self.nby
        X, Y = self.X, self.Y
        bts = np.ones(nb, dtype=np.int32)
        rect = np.zeros((nb, 4), dtype=np.int32)
        for by in range(self.nby):
            for bx in range(self.nbx):
                bi = by * self.nbx + bx
                rect[bi] = (bx * 16, by * 16,
                            min(bx * 16 + 16, X), min(by * 16 + 16, Y))
        self.capture.update(
            bts=bts, mv=np.zeros((nb, 2), dtype=np.int32), rect=rect,
            changed=True,
        )

    def decompress_i(self, src: bytes, dst: np.ndarray) -> DecoderState:
        # ScreenPressor.hx:117-295
        X, Y = self.X, self.Y
        end = X * Y
        head = src[0]
        version = (head >> 4) + 1
        if (head & 0xF) == 1:  # flat frame (:131-155)
            if self.ec is None and not self._init_entro(version):
                return DecoderState.ERROR
            self._renew_i()
            if self.bpp == 16:
                clr16 = src[0] + src[1] * 256  # head byte participates (:136)
                b = (clr16 & 0x1F) << 3
                g = ((clr16 >> 5) & 0x1F) << 3
                r = ((clr16 >> 10) & 0x1F) << 3
                clr = (r << 16) | (g << 8) | b
            else:
                clr = (src[3] << 16) | (src[2] << 8) | src[1]  # (r<<16)+(g<<8)+b
            dst[:] = clr
            self.prev = dst
            self.last_one_was_flat = clr
            self.decoded_i = True
            if self.capture is not None:
                self._capture_full_data()
            return DecoderState.ZERO
        self.last_one_was_flat = None
        if (head & 0xF) != 2:
            return DecoderState.ERROR
        if self.ec is None and not self._init_entro(version):
            return DecoderState.ERROR
        self._renew_i()
        ec = self.ec
        ec.decode_begin(src, 1)

        self.cx = self.cx1 = 0
        di = 0
        lasti = 0
        clr = 0
        k = 0
        # first row (+1 pixel) (:169-197)
        stall = 0  # corrupt stream: endless n==0 runs must not hang
        while k < X + 1:
            clr = self._decode_rgb()
            n = ec.decode_n(0)
            if n == 0:
                stall += 1
                if stall > 4096:
                    raise ValueError("stalled stream (invalid)")
            else:
                stall = 0
            k += n
            for _ in range(n):
                dst[di] = clr
                di += 1
            lasti = di - 1

        maskcx1, shiftcx1, shiftcx = self._cx_consts()
        off = -X - 1
        ptype = 0
        # main predictor-run loop (:218-286)
        stall = 0
        while di < end:
            di0 = di
            ptype = ec.decode_p(ptype)
            if ptype == 0:
                clr = self._decode_rgb()
            n = ec.decode_n(ptype)
            if ptype == 0:
                for _ in range(n):
                    dst[di] = clr
                    di += 1
                lasti = di - 1
            elif ptype == 1:
                for _ in range(n):
                    dst[di] = dst[lasti]
                    lasti = di
                    di += 1
                clr = int(dst[lasti])
            elif ptype == 2:
                for _ in range(n):
                    clr = int(dst[di + off + 1])
                    dst[di] = clr
                    di += 1
                lasti = di - 1
            elif ptype == 4:
                for _ in range(n):
                    L = int(dst[lasti])
                    U1 = int(dst[di + off + 1])
                    U0 = int(dst[di + off])
                    r = (L & 0xFF) + (U1 & 0xFF) - (U0 & 0xFF)
                    g = ((L >> 8) & 0xFF) + ((U1 >> 8) & 0xFF) - ((U0 >> 8) & 0xFF)
                    b = ((L >> 16) & 0xFF) + ((U1 >> 16) & 0xFF) - ((U0 >> 16) & 0xFF)
                    clr = ((b & 0xFF) << 16) | ((g & 0xFF) << 8) | (r & 0xFF)
                    dst[di] = clr
                    lasti = di
                    di += 1
            elif ptype == 5:
                for _ in range(n):
                    clr = int(dst[di + off])
                    dst[di] = clr
                    di += 1
                lasti = di - 1
            if di == di0:
                stall += 1
                if stall > 4096:
                    raise ValueError("stalled stream (invalid)")
            else:
                stall = 0
            self.cx1 = (clr & maskcx1) >> shiftcx1
            self.cx = clr >> shiftcx
        self.prev = dst
        self.decoded_i = True
        if self.capture is not None:
            self._capture_full_data()
        return DecoderState.ZERO

    def decompress_p(self, src: bytes, dst: np.ndarray) -> PFrameResult:
        # ScreenPressor.hx:302-484
        self.last_one_was_flat = None
        if len(src) == 0 or not self.decoded_i or src[0] == 0:
            if self.capture is not None:
                self._capture_nochange()
            return PFrameResult(self.prev, False)

        X, Y = self.X, self.Y
        maskcx1, shiftcx1, shiftcx = self._cx_consts()
        ec = self.ec
        ec.decode_begin(src, 1)

        t = ec.decode_x()
        xx1 = (ec.decode_x() << 8) + t
        t = ec.decode_x()
        xx2 = (ec.decode_x() << 8) + t

        bts = self.bts
        bts[:] = 0
        x = xx1
        while x <= xx2:
            block_type = ec.decode_bt()
            n = ec.decode_bn()
            for _ in range(n):
                bts[x] = block_type
                x += 1

        signif = bool((bts[self.insignificant_blocks:] > 0).any())

        cap = self.capture
        if cap is not None:
            nb = self.nbx * self.nby
            cap["bts"] = bts.copy()
            cap["mv"] = np.zeros((nb, 2), dtype=np.int32)
            cap["rect"] = np.zeros((nb, 4), dtype=np.int32)
            cap["changed"] = True

        prev = self.prev
        np.copyto(dst, prev)  # bts==0 / subrect pre-copies collapse to this
        stride = X
        end = X * Y
        off = -X - 1
        self.cx = self.cx1 = 0
        clr = 0
        lastmx = lastmy = 0
        d2 = dst.reshape(Y, X)
        p2 = prev.reshape(Y, X)
        for by in range(self.nby):
            for bx in range(self.nbx):
                bi = by * self.nbx + bx
                if bts[bi] <= 0:
                    continue
                x16, y16 = bx * 16, by * 16
                x1, x2 = x16, min(x16 + 16, X)
                y1, y2 = y16, min(y16 + 16, Y)
                if (bts[bi] - 1) & 1:  # subrect (:375-386)
                    x1 = ec.decode_sxy(0) + x16
                    y1 = ec.decode_sxy(1) + y16
                    x2 = ec.decode_sxy(2) + x16 + 1
                    y2 = ec.decode_sxy(3) + y16 + 1
                    # a corrupt stream can place the subrect outside the
                    # frame (edge blocks narrower than 16); reject rather
                    # than write out of bounds (mirrors native spdec.cpp)
                    if x2 > X or y2 > Y or x1 >= x2 or y1 >= y2:
                        raise ValueError(
                            f"subrect out of bounds (invalid stream): "
                            f"({x1},{y1})-({x2},{y2}) in {X}x{Y}")
                if cap is not None:
                    cap["rect"][bi] = (x1, y1, x2, y2)
                if (bts[bi] - 1) & 2:  # motion (:388-405)
                    if self.decoding_bools and ec.decode_bool():
                        mx, my = lastmx, lastmy
                    else:
                        mx = ec.decode_mx() - MSR_X
                        my = ec.decode_my() - MSR_Y
                    lastmx, lastmy = mx, my
                    if not (0 <= y1 + my and y2 + my <= Y
                            and 0 <= x1 + mx and x2 + mx <= X):
                        raise ValueError(
                            "motion vector out of bounds (invalid stream)")
                    if cap is not None:
                        cap["mv"][bi] = (mx, my)
                    d2[y1:y2, x1:x2] = p2[y1 + my : y2 + my, x1 + mx : x2 + mx]
                else:  # data (:406-467)
                    x = x1
                    y = y1
                    ptype = 0
                    stall = 0  # corrupt stream: endless n==0 runs must not hang
                    while y < y2:
                        i = y * stride + x
                        di = i
                        ptype = ec.decode_p(ptype)
                        if ptype == 0:
                            clr = self._decode_rgb()
                        n = ec.decode_n(ptype)
                        if n == 0:
                            stall += 1
                            if stall > 4096:
                                raise ValueError("stalled stream (invalid)")
                        else:
                            stall = 0
                        # Predictor reads with no neighbor (frame row/col
                        # 0) or past the frame end are OOB; the
                        # reference's JS target reads `undefined` from
                        # the Int32Array there, which coerces to 0 —
                        # mirror that instead of numpy's negative-index
                        # wrap / IndexError (ScreenPressor.hx:438-461 via
                        # js typed-array semantics).  Likewise an
                        # overlong run WALKS PAST the rect bottom (the
                        # while-y<y2 guard only stops the next run) and
                        # even past the frame; JS drops OOB writes —
                        # mirrored by the di<end guard (fuzz-found
                        # native/oracle divergence, round 3).
                        rd = (lambda ix: int(dst[ix])
                              if 0 <= ix < end else 0)
                        for _ in range(n):
                            if ptype == 1:
                                clr = rd(di - 1)
                            elif ptype == 2:
                                clr = rd(di + off + 1)
                            elif ptype == 3:
                                clr = int(prev[i]) if i < end else 0
                            elif ptype == 4:
                                # the gradient reads per BYTE from dstbytes
                                # (ScreenPressor.hx:445-448): one OOB
                                # operand pixel poisons every component sum
                                # to NaN in JS, and NaN & 0xFF is 0 — so
                                # ANY OOB operand zeroes the WHOLE color,
                                # not just its own term
                                a0, a1, a2 = di - 1, di + off + 1, di + off
                                if (0 <= a0 < end and 0 <= a1 < end
                                        and 0 <= a2 < end):
                                    L = int(dst[a0])
                                    U1 = int(dst[a1])
                                    U0 = int(dst[a2])
                                    r = (L & 0xFF) + (U1 & 0xFF) - (U0 & 0xFF)
                                    g = ((L >> 8) & 0xFF) + ((U1 >> 8) & 0xFF) - ((U0 >> 8) & 0xFF)
                                    b = ((L >> 16) & 0xFF) + ((U1 >> 16) & 0xFF) - ((U0 >> 16) & 0xFF)
                                    clr = ((b & 0xFF) << 16) | ((g & 0xFF) << 8) | (r & 0xFF)
                                else:
                                    clr = 0
                            elif ptype == 5:
                                clr = rd(di + off)
                            if di < end:
                                dst[di] = clr
                            x += 1
                            if x >= x2:
                                x = x1
                                y += 1
                                i = y * stride + x
                                di = i
                            else:
                                i += 1
                                di += 1
                        self.cx1 = (clr & maskcx1) >> shiftcx1
                        self.cx = clr >> shiftcx
        self.prev = dst
        return PFrameResult(self.prev, signif)

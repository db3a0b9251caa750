"""Entropy-coder facades: uniform symbol API over the range coder (v2) and
rANS (v3/v4), plus the matching encoder facades.

Decoder parity: EntroCoders.hx:8-313 — the EntroCoder interface (:8-24), the
RC implementation with its table set (cntab 3×4096×273, ptypetab, ntab, xxtab,
ntab2, bttab, sxytab, mvtab; :31-180) and the ANS implementation over
Context/FixedSizeRansCtx (:182-313) including the B-symbol stream reinit
(:250-254) and the raw-byte escape path of decodeClr (:235-255).

Encoder facades are new components mirroring every adaptive-state mutation so
encode→decode is an exact round trip.
"""

from __future__ import annotations

import numpy as np

from . import rans as R
from .rangecoder import RangeDecoder, RangeEncoder

MSR_X = 256  # motion search ranges (ScreenPressor.hx:21-22)
MSR_Y = 256

CXMAX = 4096  # EntroCoders.hx:27
NCXMAX = 6

# RC adaptation steps (EntroCoders.hx:43-51)
SC_STEP = 400
SC_NSTEP = 400
SC_BTSTEP = 10
SC_BTNSTEP = 20
SC_SXYSTEP = 100
SC_MSTEP = 100
SC_UNSTEP = 1000
SC_XXSTEP = 1
CNTABSZ = 273


class _RCTables:
    """Adaptive table set shared by the RC decoder and encoder facades."""

    def __init__(self) -> None:
        self.cntab = np.zeros(3 * CXMAX * CNTABSZ, dtype=np.uint32)
        self.ptypetab = np.zeros((NCXMAX, 7), dtype=np.uint32)
        self.ntab = np.zeros((NCXMAX, 257), dtype=np.uint32)
        self.xxtab = np.zeros(257, dtype=np.uint32)
        self.ntab2 = np.zeros(257, dtype=np.uint32)
        self.bttab = np.zeros(6, dtype=np.uint32)
        self.sxytab = np.zeros((4, 17), dtype=np.uint32)
        self.mvtab = [np.zeros(MSR_X * 2 + 1, dtype=np.uint32),
                      np.zeros(MSR_Y * 2 + 1, dtype=np.uint32)]

    def preinit(self) -> None:
        # EntroCoders.hx:74-79
        for chan in range(3):
            for ctx in range(CXMAX):
                self.cntab[((chan << 12) + ctx) * CNTABSZ + 16] = 0

    def renew_i(self) -> None:
        # EntroCoders.hx:81-130
        cn = self.cntab
        for chan in range(3):
            base = chan * CXMAX * CNTABSZ
            for ctx in range(CXMAX):
                p = base + ctx * CNTABSZ
                if cn[p + 16] != 256:
                    cn[p + 17 : p + 17 + 256] = 1
                    cn[p : p + 16] = 16
                    cn[p + 16] = 256
        self.ntab[:, :256] = 1
        self.ntab[:, 256] = 256
        self.ptypetab[:, :6] = 1
        self.ptypetab[:, 6] = 6
        self.xxtab[:256] = 1
        self.xxtab[256] = 256
        self.ntab2[:256] = 1
        self.ntab2[256] = 256
        self.bttab[:5] = 1
        self.bttab[5] = 5
        self.sxytab[:, :16] = 1
        self.sxytab[:, 16] = 16
        self.mvtab[0][: MSR_X * 2] = 1
        self.mvtab[0][MSR_X * 2] = MSR_X * 2
        self.mvtab[1][: MSR_Y * 2] = 1
        self.mvtab[1][MSR_Y * 2] = MSR_Y * 2


class EntroCoderRC:
    """EntroCoders.hx:31-180 (ScreenPressor v2, range coder)."""

    def __init__(self) -> None:
        self.t = _RCTables()
        self.rc = RangeDecoder()

    def can_decode_bool(self) -> bool:
        return False

    def different_constants_for_16bpp(self) -> bool:
        return True

    def preinit(self) -> None:
        self.t.preinit()

    def renew_i(self) -> None:
        self.t.renew_i()

    def decode_begin(self, src: bytes, pos0: int) -> None:
        self.rc.decode_begin(src, pos0)

    def decode_clr(self, cxi: int) -> int:
        return self.rc.decode_val_uni(self.t.cntab, cxi * CNTABSZ, SC_STEP)

    def decode_n(self, ptype: int) -> int:
        return self.rc.decode_val(self.t.ntab[ptype], 0, 256, SC_NSTEP)

    def decode_p(self, ptype: int) -> int:
        return self.rc.decode_val(self.t.ptypetab[ptype], 0, 6, SC_UNSTEP)

    def decode_x(self) -> int:
        return self.rc.decode_val(self.t.xxtab, 0, 256, SC_XXSTEP)

    def decode_bt(self) -> int:
        return self.rc.decode_val(self.t.bttab, 0, 5, SC_BTSTEP)

    def decode_bn(self) -> int:
        return self.rc.decode_val(self.t.ntab2, 0, 256, SC_BTNSTEP)

    def decode_sxy(self, n: int) -> int:
        return self.rc.decode_val(self.t.sxytab[n], 0, 16, SC_SXYSTEP)

    def decode_mx(self) -> int:
        return self.rc.decode_val(self.t.mvtab[0], 0, MSR_X * 2, SC_MSTEP)

    def decode_my(self) -> int:
        return self.rc.decode_val(self.t.mvtab[1], 0, MSR_Y * 2, SC_MSTEP)

    def decode_bool(self) -> bool:
        return False


class EntroEncoderRC:
    """Encoder twin of EntroCoderRC — one RangeEncoder per frame."""

    def __init__(self) -> None:
        self.t = _RCTables()
        self.rc: RangeEncoder | None = None

    def can_bool(self) -> bool:
        return False

    def different_constants_for_16bpp(self) -> bool:
        return True

    def preinit(self) -> None:
        self.t.preinit()

    def renew_i(self) -> None:
        self.t.renew_i()

    def begin_frame(self) -> None:
        self.rc = RangeEncoder()

    def end_frame(self) -> bytes:
        data = self.rc.finish()
        self.rc = None
        return data

    def encode_clr(self, cxi: int, c: int) -> None:
        self.rc.encode_val_uni(self.t.cntab, cxi * CNTABSZ, SC_STEP, c)

    def encode_n(self, ptype: int, c: int) -> None:
        self.rc.encode_val(self.t.ntab[ptype], 0, 256, SC_NSTEP, c)

    def encode_p(self, ptype: int, c: int) -> None:
        self.rc.encode_val(self.t.ptypetab[ptype], 0, 6, SC_UNSTEP, c)

    def encode_x(self, c: int) -> None:
        self.rc.encode_val(self.t.xxtab, 0, 256, SC_XXSTEP, c)

    def encode_bt(self, c: int) -> None:
        self.rc.encode_val(self.t.bttab, 0, 5, SC_BTSTEP, c)

    def encode_bn(self, c: int) -> None:
        self.rc.encode_val(self.t.ntab2, 0, 256, SC_BTNSTEP, c)

    def encode_sxy(self, n: int, c: int) -> None:
        self.rc.encode_val(self.t.sxytab[n], 0, 16, SC_SXYSTEP, c)

    def encode_mx(self, c: int) -> None:
        self.rc.encode_val(self.t.mvtab[0], 0, MSR_X * 2, SC_MSTEP, c)

    def encode_my(self, c: int) -> None:
        self.rc.encode_val(self.t.mvtab[1], 0, MSR_Y * 2, SC_MSTEP, c)

    def encode_bool(self, flag: bool) -> None:
        raise NotImplementedError("v2 has no bool path")


class UnencodableSymbolError(ValueError):
    """Raised when a symbol's interval lies at/above PROB_SCALE.

    Reference quirk: with v3's f0=64, Cx6.createFrom2 can build an interval
    layout whose total exceeds PROB_SCALE (ANS.hx:514: 256-oldd+oldd*f0+f0 up
    to 4289 for oldd≈63).  Symbols above 4095 are unreachable by the decoder
    (someFreq = r & 4095, ANS.hx:35) — the reference silently can never decode
    them, so an encoder must never emit them.  v4 (f0=32) layouts stay ≤4096.
    """


class _AnsTables:
    """Context/table set shared by the ANS decoder and encoder facades
    (EntroCoderANS constructor, EntroCoders.hx:195-211)."""

    def __init__(self, f0: int) -> None:
        self.cntab = [R.Context(f0) for _ in range(CXMAX * 3)]
        self.ntab = [R.FixedSizeRansCtx(256) for _ in range(NCXMAX)]
        self.ptypetab = [R.FixedSizeRansCtx(6) for _ in range(6)]
        self.xxtab = R.FixedSizeRansCtx(256)
        self.ntab2 = R.FixedSizeRansCtx(256)
        self.bttab = R.FixedSizeRansCtx(5)
        self.sxytab = [R.FixedSizeRansCtx(16) for _ in range(4)]
        self.mvtab = [R.FixedSizeRansCtx(512) for _ in range(2)]

    def renew_i(self) -> None:
        # EntroCoders.hx:216-227
        for c in self.cntab:
            c.renew()
        for t in self.ntab:
            t.renew()
        for t in self.ptypetab:
            t.renew()
        self.xxtab.renew()
        self.ntab2.renew()
        self.bttab.renew()
        for t in self.sxytab:
            t.renew()
        for t in self.mvtab:
            t.renew()


class EntroCoderANS:
    """EntroCoders.hx:182-313 (ScreenPressor v3/v4, rANS)."""

    def __init__(self, f0: int) -> None:
        self.t = _AnsTables(f0)
        self.rans: R.Rans | None = None
        self.n_dec = 0

    def can_decode_bool(self) -> bool:
        return True

    def different_constants_for_16bpp(self) -> bool:
        return False

    def preinit(self) -> None:
        pass

    def renew_i(self) -> None:
        self.t.renew_i()

    def decode_begin(self, src: bytes, pos0: int) -> None:
        self.rans = R.Rans(src, pos0)
        self.n_dec = 0

    def _tick(self) -> None:
        # EntroCoders.hx:250-254: reinit every B counted symbols
        self.n_dec += 1
        if self.n_dec == R.B:
            self.rans.reinit()
            self.n_dec = 0

    def decode_clr(self, cxi: int) -> int:
        # EntroCoders.hx:235-255
        dcx = self.t.cntab[cxi]
        res = dcx.decode(self.rans.dec_get())
        if res is not None:
            c, freq, cumfreq = res
            self.rans.dec_advance(cumfreq, freq)
        else:
            c = self.rans.raw()
            dcx.update(c)
        self._tick()
        return c

    def decode_bool(self) -> bool:
        # EntroCoders.hx:259-269
        f = self.rans.dec_get()
        flag = f >= R.PROB_SCALE >> 1
        self.rans.dec_advance(R.PROB_SCALE >> 1 if flag else 0, R.PROB_SCALE >> 1)
        self._tick()
        return flag

    def _decode_f(self, dcx: R.FixedSizeRansCtx) -> int:
        # EntroCoders.hx:271-280
        c, freq, cumfreq = dcx.decode(self.rans.dec_get())
        self.rans.dec_advance(cumfreq, freq)
        self._tick()
        return c

    def decode_n(self, ptype: int) -> int:
        return self._decode_f(self.t.ntab[ptype])

    def decode_p(self, ptype: int) -> int:
        return self._decode_f(self.t.ptypetab[ptype])

    def decode_x(self) -> int:
        return self._decode_f(self.t.xxtab)

    def decode_bt(self) -> int:
        return self._decode_f(self.t.bttab)

    def decode_bn(self) -> int:
        return self._decode_f(self.t.ntab2)

    def decode_sxy(self, n: int) -> int:
        return self._decode_f(self.t.sxytab[n])

    def decode_mx(self) -> int:
        return self._decode_f(self.t.mvtab[0])

    def decode_my(self) -> int:
        return self._decode_f(self.t.mvtab[1])


class EntroEncoderANS:
    """Encoder twin of EntroCoderANS: forward context simulation feeding a
    reverse-order chunked rANS encoder."""

    def __init__(self, f0: int) -> None:
        self.t = _AnsTables(f0)
        self.enc: R.RansChunkEncoder | None = None

    def can_bool(self) -> bool:
        return True

    def different_constants_for_16bpp(self) -> bool:
        return False

    def preinit(self) -> None:
        pass

    def renew_i(self) -> None:
        self.t.renew_i()

    def begin_frame(self) -> None:
        self.enc = R.RansChunkEncoder()

    def end_frame(self) -> bytes:
        data = self.enc.finalize()
        self.enc = None
        return data

    def encode_clr(self, cxi: int, c: int) -> None:
        dcx = self.t.cntab[cxi]
        res = dcx.encode(c)
        if res is not None:
            freq, cumfreq = res
            if cumfreq + freq > R.PROB_SCALE:
                raise UnencodableSymbolError(
                    f"symbol {c} in context {cxi} maps to interval "
                    f"[{cumfreq}, {cumfreq + freq}) beyond PROB_SCALE"
                )
            self.enc.put(cumfreq, freq)
        else:
            self.enc.put_raw(c, counted=True)
            dcx.update(c)

    def encode_bool(self, flag: bool) -> None:
        half = R.PROB_SCALE >> 1
        self.enc.put(half if flag else 0, half)

    def _encode_f(self, dcx: R.FixedSizeRansCtx, c: int) -> None:
        freq, cumfreq = dcx.encode(c)
        self.enc.put(cumfreq, freq)

    def encode_n(self, ptype: int, c: int) -> None:
        self._encode_f(self.t.ntab[ptype], c)

    def encode_p(self, ptype: int, c: int) -> None:
        self._encode_f(self.t.ptypetab[ptype], c)

    def encode_x(self, c: int) -> None:
        self._encode_f(self.t.xxtab, c)

    def encode_bt(self, c: int) -> None:
        self._encode_f(self.t.bttab, c)

    def encode_bn(self, c: int) -> None:
        self._encode_f(self.t.ntab2, c)

    def encode_sxy(self, n: int, c: int) -> None:
        self._encode_f(self.t.sxytab[n], c)

    def encode_mx(self, c: int) -> None:
        self._encode_f(self.t.mvtab[0], c)

    def encode_my(self, c: int) -> None:
        self._encode_f(self.t.mvtab[1], c)

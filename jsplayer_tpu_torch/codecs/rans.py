"""Byte-wise rANS + escalating adaptive context models (ScreenPressor v3/v4).

Bit-exact re-implementation of the reference entropy layer (ANS.hx:1-872):

  Rans        — rANS decoder state, B=131072-symbol reinit, 12-bit probs
                (ANS.hx:5-49)
  RansChunkEncoder — NEW: reverse-order rANS encoder producing the exact byte
                stream Rans consumes, with raw-byte bypass interleaving and
                per-B-chunk state framing
  FixedSizeRansCtx — static-size adaptive table with decTable bucket LUT
                (ANS.hx:54-145)
  Cx1/Cx2/Cx3 — symbol-list escape contexts (ANS.hx:179-208)
  Cx4/Cx5     — sorted small contexts over SmallContext (ANS.hx:210-392)
  Cx6         — mid-size freq-sorted context with fshift scaling (ANS.hx:394-704)
  Cx7         — full 256-entry table (ANS.hx:706-772)
  Context     — escalation dispatcher (ANS.hx:785-860)

Every context class carries BOTH a decode path (symbol from quantized
frequency, mirroring the reference line-for-line) and an encode path (interval
from known symbol) that drives *identical* state mutations — the encoder is a
forward simulation of the decoder, which is what makes reverse-order rANS
encoding of adaptive models possible.
"""

from __future__ import annotations

from typing import Optional

B = 131072  # state reload period in decoded symbols (ANS.hx:10)
PROB_SCALE = 4096
RANS_BYTE_L = 1 << 23  # ANS.hx:33


class Rans:
    """rANS decoder state (ANS.hx:5-49)."""

    __slots__ = ("r", "pos", "data")

    def __init__(self, data: bytes, pos0: int = 0):
        self.data = data
        self._reinit_at(pos0)

    def _reinit_at(self, i: int) -> None:
        d = self.data
        self.r = d[i] | (d[i + 1] << 8) | (d[i + 2] << 16) | (d[i + 3] << 24)
        self.pos = i + 4

    def reinit(self) -> None:
        self._reinit_at(self.pos)

    def dec_get(self) -> int:
        return self.r & 4095

    def dec_advance(self, start: int, freq: int) -> None:
        x = self.r
        x = freq * (x >> 12) + (x & 4095) - start
        d = self.data
        while x < RANS_BYTE_L:
            x = (x << 8) | (d[self.pos] if self.pos < len(d) else 0)
            self.pos += 1
        self.r = x

    def raw(self) -> int:
        b = self.data[self.pos]
        self.pos += 1
        return b


class RansChunkEncoder:
    """Reverse-order rANS encoder with raw-byte bypass (new component).

    Usage: record ops forward via put()/put_raw(), splitting into chunks of
    exactly B counted ops (the caller tracks nDec parity with
    EntroCoderANS.decodeClr, EntroCoders.hx:235-255); finalize() emits
    the concatenated chunk streams, each framed by its 4-byte little-endian
    initial state (Rans.reinitImpl, ANS.hx:22-31).
    """

    def __init__(self) -> None:
        self._chunks: list[list[tuple]] = [[]]
        self._count = 0  # counted ops in current chunk

    def _op(self, op: tuple, counted: bool) -> None:
        self._chunks[-1].append(op)
        if counted:
            self._count += 1
            if self._count == B:
                self._chunks.append([])
                self._count = 0

    def put(self, start: int, freq: int) -> None:
        self._op(("s", start, freq), True)

    def put_raw(self, byte: int, counted: bool) -> None:
        """Bypass byte. ``counted=True`` when emitted from a decodeClr-style
        call that still increments nDec (EntroCoders.hx:246-254)."""
        self._op(("r", byte), counted)

    def finalize(self) -> bytes:
        out = bytearray()
        for ops in self._chunks:
            out += self._encode_chunk(ops)
        return bytes(out)

    @staticmethod
    def _encode_chunk(ops: list[tuple]) -> bytes:
        buf = bytearray()  # built back-to-front, reversed at end
        x = RANS_BYTE_L
        for op in reversed(ops):
            if op[0] == "r":
                buf.append(op[1])
            else:
                _, start, freq = op
                x_max = ((RANS_BYTE_L >> 12) << 8) * freq
                while x >= x_max:
                    buf.append(x & 0xFF)
                    x >>= 8
                x = ((x // freq) << 12) + (x % freq) + start
        # 4-byte LE initial state, prepended (i.e. appended last here)
        buf += bytes([(x >> 24) & 0xFF, (x >> 16) & 0xFF, (x >> 8) & 0xFF, x & 0xFF])
        buf.reverse()
        return bytes(buf)


# ---------------------------------------------------------------------------
# FixedSizeRansCtx (ANS.hx:54-145)
# ---------------------------------------------------------------------------

STEP_FX = 16
DSHIFT = 7
D = 1 << DSHIFT


def _fill_dec_table(tab: list, cf: int, fr: int, i: int) -> None:
    """Write decTable[k]=i for the buckets covering [cf, cf+fr).  The
    reference's decTable is a 32-byte Uint8Array where out-of-range writes
    are silently dropped by JS (Cx7.createFrom6 can overshoot PROB_SCALE
    after a Cx6 rescale, ANS.hx:762-769) — clamp to mirror that."""
    k0 = (cf + D - 1) >> DSHIFT
    k1 = ((cf + fr - 1) >> DSHIFT) + 1
    for k in range(k0, min(k1, len(tab))):
        if k >= 0:
            tab[k] = i


class FixedSizeRansCtx:
    __slots__ = ("nsym", "freq", "cumfreq", "cnts", "cntsum", "dec_table")

    def __init__(self, nsym: int):
        self.nsym = nsym
        self.freq = [0] * nsym
        self.cumfreq = [0] * nsym
        self.cnts = [0] * nsym
        self.cntsum = 0
        self.dec_table = [0] * (PROB_SCALE // D)

    def renew(self) -> None:
        # ANS.hx:128-144 — equal probabilities
        fr = PROB_SCALE // self.nsym
        c0 = fr - (fr >> 1)
        self.cntsum = c0 * self.nsym
        cf = 0
        for i in range(self.nsym):
            self.freq[i] = fr
            self.cumfreq[i] = cf
            self.cnts[i] = c0
            _fill_dec_table(self.dec_table, cf, fr, i)
            cf += fr

    def _incr_cnt(self, c: int) -> None:
        # ANS.hx:85-103
        self.cnts[c] += STEP_FX
        self.cntsum += STEP_FX
        if self.cntsum + STEP_FX > PROB_SCALE:
            self.cntsum = 0
            cf = 0
            for j in range(self.nsym):
                fr = self.cnts[j]
                self.freq[j] = fr
                self.cumfreq[j] = cf
                _fill_dec_table(self.dec_table, cf, fr, j)
                cf += fr
                self.cnts[j] -= fr >> 1
                self.cntsum += self.cnts[j]

    def decode(self, some_freq: int) -> tuple[int, int, int]:
        """→ (c, freq, cumFreq) (ANS.hx:105-126)."""
        c0 = self.dec_table[some_freq >> DSHIFT]
        n = self.nsym
        for j in range(c0, n - 1):
            if self.cumfreq[j + 1] > some_freq:
                res = (j, self.freq[j], self.cumfreq[j])
                self._incr_cnt(j)
                return res
        res = (n - 1, self.freq[n - 1], self.cumfreq[n - 1])
        self._incr_cnt(n - 1)
        return res

    def encode(self, c: int) -> tuple[int, int]:
        """→ (freq, cumFreq) for symbol c; same adaptation as decode."""
        res = (self.freq[c], self.cumfreq[c])
        self._incr_cnt(c)
        return res


# ---------------------------------------------------------------------------
# Symbol-list contexts Cx1/Cx2/Cx3 (ANS.hx:155-208)
# ---------------------------------------------------------------------------

FOUND, ADDED, NOROOM = 0, 1, 2


class SymbList:
    __slots__ = ("symb", "d", "cap")

    def __init__(self, cap: int):
        self.symb = [0] * cap
        self.cap = cap
        self.d = 0

    def find_or_add(self, c: int) -> int:
        # ANS.hx:163-172
        for i in range(self.d):
            if self.symb[i] == c:
                return FOUND
        if self.d < self.cap:
            self.symb[self.d] = c
            self.d += 1
            return ADDED
        return NOROOM


def make_cx1(c: int) -> SymbList:
    x = SymbList(14)
    x.symb[0] = c
    x.d = 1
    return x


def extend_list(prev: SymbList, c: int, cap: int) -> SymbList:
    # Cx2/Cx3 constructors (ANS.hx:188-208)
    x = SymbList(cap)
    x.symb[: prev.d] = prev.symb[: prev.d]
    x.symb[prev.d] = c
    x.d = prev.d + 1
    return x


# ---------------------------------------------------------------------------
# SmallContext / Cx4 / Cx5 (ANS.hx:210-392)
# ---------------------------------------------------------------------------

SC_F0 = 50  # SmallContext.f0 (ANS.hx:216)


class SmallContext:
    __slots__ = ("d", "maxpos", "S", "symbols", "freqs", "_totfr", "cntsum")

    def __init__(self, size: int):
        self.S = size
        self.symbols = [0] * size
        self.freqs = [0] * size
        self.maxpos = 0
        self.d = 0
        self._totfr = 0  # mirrors static SmallContext.totFr (ANS.hx:217)
        self.cntsum = 0  # used by Cx5 only

    def _create(self, c1: SymbList, c: int) -> None:
        # ANS.hx:226-238
        self.d = c1.d
        ss = sorted(c1.symb[: self.d])
        for i in range(self.d):
            self.symbols[i] = ss[i]
            if ss[i] == c:
                self.freqs[i] = 2 * SC_F0
                self.maxpos = i
            else:
                self.freqs[i] = SC_F0

    def _add_symb(self, pos: int, c: int) -> bool:
        # ANS.hx:240-252
        if self.d == self.S:
            return False
        for i in range(self.d - 1, pos - 1, -1):
            self.symbols[i + 1] = self.symbols[i]
            self.freqs[i + 1] = self.freqs[i]
        self.symbols[pos] = c
        self.freqs[pos] = SC_F0
        self.d += 1
        if self.maxpos >= pos:
            self.maxpos += 1
        self._totfr += SC_F0
        if self._totfr + SC_F0 > PROB_SCALE:
            self._rescale()
        return True

    def _rescale(self) -> None:
        # ANS.hx:254-261
        s = 256 - self.d
        for i in range(self.d):
            self.freqs[i] -= self.freqs[i] >> 1
            s += self.freqs[i]
        self._totfr = s

    @staticmethod
    def _shift_for(totfr0: int) -> tuple[int, int]:
        shift = 0
        tot = totfr0
        while tot <= PROB_SCALE // 2:
            tot <<= 1
            shift += 1
        return shift, tot

    def _decode_sc(self, some_freq: int, totfr0: int) -> tuple[tuple, bool]:
        """ANS.hx:263-309 → ((c, freq, cumFreq), fit)."""
        self._totfr = totfr0
        shift, tot = self._shift_for(totfr0)
        some_freq >>= shift
        bonus = (PROB_SCALE - tot) >> shift
        max_freq = self.freqs[self.maxpos]
        self.freqs[self.maxpos] += bonus
        cum_fr = 0
        last_symb = 0
        pos = 0
        while pos < self.d:
            s = self.symbols[pos]
            start_fr = cum_fr + s - last_symb
            if some_freq < start_fr:  # unmet symbol below s
                c = some_freq - cum_fr + last_symb
                cum_fr = some_freq
                rcv = (c, 1 << shift, cum_fr << shift)
                self.freqs[self.maxpos] = max_freq
                return rcv, self._add_symb(pos, c)
            fr = self.freqs[pos]
            if start_fr + fr > some_freq:  # met
                c = s
                cum_fr += c - last_symb
                rcv = (c, fr << shift, cum_fr << shift)
                self.freqs[self.maxpos] = max_freq
                self._met_update(pos)
                return rcv, True
            cum_fr += s - last_symb + fr
            last_symb = s + 1
            pos += 1
        self.freqs[self.maxpos] = max_freq
        c = last_symb + some_freq - cum_fr
        rcv = (c, 1 << shift, some_freq << shift)
        return rcv, self._add_symb(pos, c)

    def _met_update(self, pos: int) -> None:
        # ANS.hx:290-293
        self.freqs[pos] += SC_F0
        self._totfr += SC_F0
        if pos != self.maxpos and self.freqs[pos] > self.freqs[self.maxpos]:
            self.maxpos = pos
        if self._totfr + SC_F0 > PROB_SCALE:
            self._rescale()

    def _encode_sc(self, c: int, totfr0: int) -> tuple[tuple, bool]:
        """Interval for known symbol c — same walk & mutations as _decode_sc."""
        self._totfr = totfr0
        shift, tot = self._shift_for(totfr0)
        bonus = (PROB_SCALE - tot) >> shift
        max_freq = self.freqs[self.maxpos]
        self.freqs[self.maxpos] += bonus
        cum_fr = 0
        last_symb = 0
        pos = 0
        while pos < self.d:
            s = self.symbols[pos]
            if c < s:  # unmet, below s
                sf = cum_fr + (c - last_symb)
                rcv = (c, 1 << shift, sf << shift)
                self.freqs[self.maxpos] = max_freq
                return rcv, self._add_symb(pos, c)
            fr = self.freqs[pos]
            if c == s:  # met
                cum_fr += c - last_symb
                rcv = (c, fr << shift, cum_fr << shift)
                self.freqs[self.maxpos] = max_freq
                self._met_update(pos)
                return rcv, True
            cum_fr += s - last_symb + fr
            last_symb = s + 1
            pos += 1
        self.freqs[self.maxpos] = max_freq
        sf = cum_fr + (c - last_symb)
        rcv = (c, 1 << shift, sf << shift)
        return rcv, self._add_symb(pos, c)


class Cx4(SmallContext):
    """ANS.hx:312-327."""

    def __init__(self, c1: SymbList, c: int):
        super().__init__(4)
        self._create(c1, c)

    def _totfr0(self) -> int:
        f = self.freqs
        return f[0] + f[1] + f[2] + f[3] + 256 - self.d

    def decode(self, some_freq: int) -> tuple[tuple, bool]:
        return self._decode_sc(some_freq, self._totfr0())

    def encode(self, c: int) -> tuple[tuple, bool]:
        return self._encode_sc(c, self._totfr0())

    def upgrade(self, c: int) -> "Cx5":
        return Cx5.from_cx4(self, c)


class Cx5(SmallContext):
    """ANS.hx:329-392."""

    def __init__(self) -> None:
        super().__init__(16)

    @staticmethod
    def from_cx1(c1: SymbList, c: int) -> "Cx5":
        cx = Cx5()
        cx._create(c1, c)
        cx._calc_sum()
        return cx

    @staticmethod
    def from_cx4(c4: Cx4, c: int) -> "Cx5":
        # ANS.hx:350-372
        cx = Cx5()
        i = 0
        dd = c4.d
        totfr = 0
        while i < dd and c4.symbols[i] < c:
            cx.symbols[i] = c4.symbols[i]
            cx.freqs[i] = c4.freqs[i]
            totfr += cx.freqs[i]
            i += 1
        j = i
        cx.symbols[j] = c
        cx.freqs[j] = SC_F0
        totfr += SC_F0
        j += 1
        while i < dd:
            cx.symbols[j] = c4.symbols[i]
            cx.freqs[j] = c4.freqs[i]
            totfr += cx.freqs[j]
            i += 1
            j += 1
        cx.d = dd + 1
        if totfr > PROB_SCALE:
            cx._rescale()
        cx._calc_sum()
        return cx

    def _calc_sum(self) -> None:
        # ANS.hx:374-378
        totfr = 256 - self.d
        for i in range(self.d):
            totfr += self.freqs[i]
        self.cntsum = totfr

    def decode(self, some_freq: int) -> tuple[tuple, bool]:
        rcv, fit = self._decode_sc(some_freq, self.cntsum)
        self.cntsum = self._totfr
        return rcv, fit

    def encode(self, c: int) -> tuple[tuple, bool]:
        rcv, fit = self._encode_sc(c, self.cntsum)
        self.cntsum = self._totfr
        return rcv, fit

    def upgrade(self, c: int) -> "Cx6":
        cx = Cx6()
        cx.create_from5(self, c)
        return cx


# ---------------------------------------------------------------------------
# Cx6 (ANS.hx:394-704)
# ---------------------------------------------------------------------------

CX6_STEP = 25


class Cx6:
    __slots__ = ("symbols", "freq", "cumfreq", "cnts", "cntsum", "d", "fshift",
                 "f0")

    def __init__(self, f0: int = 32):
        # f0: 32 for v4, 64 for v3 (ANS.hx:409, set via EntroCoders.hx:210)
        self.f0 = f0
        self.symbols: list[int] = []
        self.freq: list[int] = []
        self.cumfreq: list[int] = []
        self.cnts: list[int] = []
        self.cntsum = 0
        self.d = 0
        self.fshift = 0

    def _init(self, S: int) -> None:
        self.symbols = [0] * S
        self.freq = [0] * S
        self.cumfreq = [0] * S
        self.cnts = [0] * S  # cnts[S] is modeled by self.cntsum
        self.cntsum = 0

    @property
    def S(self) -> int:
        return len(self.symbols)

    def create_from5(self, c5: Cx5, c: int) -> None:
        # ANS.hx:431-505
        self._init(32)
        oldd = c5.d
        totfr = 256 - oldd
        for i in range(oldd):
            totfr += c5.freqs[i]
        shift = 0
        tot = totfr
        while tot <= PROB_SCALE // 2:
            tot <<= 1
            shift += 1
        cum_fr = 0
        last_symb = 0
        for pos in range(oldd):
            s = c5.symbols[pos]
            cum_fr += s - last_symb
            cfr = c5.freqs[pos]
            fr = cfr << shift
            self.freq[pos] = fr
            self.cumfreq[pos] = cum_fr << shift
            self.cnts[pos] = fr - (fr >> 1)
            self.symbols[pos] = s
            cum_fr += cfr
            last_symb = s + 1
        self.fshift = shift
        # interval for the new symbol c (unmet-symbol formula, ANS.hx:461-477)
        fr_freq = 1 << shift
        fr_cumfreq = 0
        if c > 0:
            lower_sym = -1
            lfreq = 0
            lcumfreq = 0
            for i in range(oldd):
                s = self.symbols[i]
                if s > lower_sym and s < c:
                    lower_sym = s
                    lfreq = self.freq[i]
                    lcumfreq = self.cumfreq[i]
            if lfreq > 0:
                fr_cumfreq = lcumfreq + lfreq + ((c - lower_sym - 1) << shift)
            else:
                fr_cumfreq = c << shift
        self.freq[oldd] = fr_freq
        self.cumfreq[oldd] = fr_cumfreq
        self.cnts[oldd] = fr_freq - (fr_freq >> 1)
        self.symbols[oldd] = c
        self.d = oldd + 1
        step = CX6_STEP << self.fshift
        self.cnts[oldd] += step
        self.cntsum += step
        if self.cntsum + step > PROB_SCALE:
            self._rescale_dec()
        self._calc_sum()
        # freq-sort (descending), ANS.hx:491-504
        for i in range(self.d - 1):
            for j in range(i + 1, self.d):
                if self.freq[j] > self.freq[i]:
                    self.freq[i], self.freq[j] = self.freq[j], self.freq[i]
                    self.cumfreq[i], self.cumfreq[j] = self.cumfreq[j], self.cumfreq[i]
                    self.cnts[i], self.cnts[j] = self.cnts[j], self.cnts[i]
                    self.symbols[i], self.symbols[j] = self.symbols[j], self.symbols[i]

    def create_from2(self, cx: SymbList, c: int) -> None:
        # ANS.hx:507-555
        S0 = 32 if cx.d <= 32 else 64
        self._init(S0)
        f0 = self.f0
        oldd = cx.d
        totfr = 256 - oldd + oldd * f0 + f0
        shift = 0
        tot = totfr
        while tot <= PROB_SCALE // 2:
            tot <<= 1
            shift += 1
        cum_fr = 0
        last_symb = 0
        ss = sorted(cx.symb[:oldd])
        new_symb_pos = 0
        for pos in range(oldd):
            s = ss[pos]
            cum_fr += s - last_symb
            if s == c:
                new_symb_pos = pos
                cfr = f0 * 2
            else:
                cfr = f0
            fr = cfr << shift
            self.freq[pos] = fr
            self.cumfreq[pos] = cum_fr << shift
            self.symbols[pos] = s
            self.cnts[pos] = fr - (fr >> 1)
            cum_fr += cfr
            last_symb = s + 1
        self.d = oldd
        self.fshift = shift
        self._calc_sum()
        if new_symb_pos > 0:  # move the repeated symbol to slot 0
            for arr in (self.freq, self.cumfreq, self.cnts, self.symbols):
                arr[0], arr[new_symb_pos] = arr[new_symb_pos], arr[0]

    def _calc_sum(self) -> None:
        # ANS.hx:571-578
        shft = self.fshift - 1 if self.fshift > 0 else 0
        s = (256 - self.d) << shft
        for i in range(self.S):
            s += self.cnts[i]
        self.cntsum = s

    def _rescale_dec(self) -> None:
        # ANS.hx:580-604
        sh = self.fshift - 1 if self.fshift > 0 else 0
        c0 = 1 << sh
        _cnts = [c0] * 256
        for i in range(self.d):
            _cnts[self.symbols[i]] = self.cnts[i]
        _freq = [0] * 256
        _cumfreq = [0] * 256
        cum_fr = 0
        for i in range(256):
            _freq[i] = _cnts[i]
            _cumfreq[i] = cum_fr
            cum_fr += _cnts[i]
        if self.fshift > 0:
            self.fshift -= 1
        shft = self.fshift - 1 if self.fshift > 0 else 0
        cntsum = (256 - self.d) << shft
        for i in range(self.d):
            self.cnts[i] -= self.cnts[i] >> 1
            cntsum += self.cnts[i]
            idx = self.symbols[i]
            self.freq[i] = _freq[idx]
            self.cumfreq[i] = _cumfreq[idx]
        self.cntsum = cntsum

    def _unmet_interval(self, c: int, lfreq: int, lcumfreq: int,
                        lower_sym: int) -> tuple[int, int]:
        fr_freq = 1 << self.fshift
        if lfreq > 0:
            x = c - lower_sym - 1
            fr_cumfreq = lcumfreq + lfreq + (x << self.fshift)
        else:
            fr_cumfreq = c << self.fshift
        return fr_freq, fr_cumfreq

    def decode(self, some_freq: int) -> tuple[tuple, bool]:
        """ANS.hx:606-650 → ((c, freq, cumFreq), handled)."""
        lfreq = 0
        lcumfreq = 0
        lower_sym = 0
        for i in range(self.d):
            cf = self.cumfreq[i]
            if cf <= some_freq:
                fr = self.freq[i]
                if cf + fr > some_freq:
                    rcv = (self.symbols[i], fr, cf)
                    self._incr_cnt_dec(i)
                    return rcv, True
                if cf >= lcumfreq:
                    lfreq = fr
                    lcumfreq = cf
                    lower_sym = self.symbols[i]
        fr_freq = 1 << self.fshift
        if lfreq > 0:
            cum_fr = lcumfreq + lfreq
            x = (some_freq - cum_fr) >> self.fshift
            c = x + lower_sym + 1
            fr_cumfreq = lcumfreq + lfreq + (x << self.fshift)
        else:
            c = some_freq >> self.fshift
            fr_cumfreq = c << self.fshift
        rcv = (c, fr_freq, fr_cumfreq)
        return rcv, self._add_or_grow(c, fr_freq, fr_cumfreq)

    def encode(self, c: int) -> tuple[tuple, bool]:
        """Interval for known symbol c — mirror of decode (value-monotone
        cumfreq layout guarantees the same lower-neighbor choice)."""
        lfreq = 0
        lcumfreq = 0
        lower_sym = 0
        for i in range(self.d):
            if self.symbols[i] == c:
                rcv = (c, self.freq[i], self.cumfreq[i])
                self._incr_cnt_dec(i)
                return rcv, True
            if self.symbols[i] < c:
                cf = self.cumfreq[i]
                if cf >= lcumfreq:
                    lfreq = self.freq[i]
                    lcumfreq = cf
                    lower_sym = self.symbols[i]
        fr_freq, fr_cumfreq = self._unmet_interval(c, lfreq, lcumfreq, lower_sym)
        rcv = (c, fr_freq, fr_cumfreq)
        return rcv, self._add_or_grow(c, fr_freq, fr_cumfreq)

    def _add_or_grow(self, c: int, fr_freq: int, fr_cumfreq: int) -> bool:
        # ANS.hx:642-649
        p = self._add_dec(c, fr_freq, fr_cumfreq)
        if p < 0:
            if self.S == 64:
                return False  # upgrade to Cx7
            self._grow_dec()
            p = self._add_dec(c, fr_freq, fr_cumfreq)
        self._incr_cnt_dec(p)
        return True

    def _add_dec(self, c: int, freq: int, cumfreq: int) -> int:
        # ANS.hx:652-661
        if self.d >= 40 or self.d >= self.S:
            return -1
        pos = self.d
        self.symbols[pos] = c
        self.freq[pos] = freq
        self.cumfreq[pos] = cumfreq
        self.cnts[pos] = freq - (freq >> 1)
        self.d += 1
        return pos

    def _grow_dec(self) -> None:
        # ANS.hx:663-678 — cntsum carried over
        S2 = self.S * 2
        grow = S2 - self.S
        self.symbols += [0] * grow
        self.freq += [0] * grow
        self.cumfreq += [0] * grow
        self.cnts += [0] * grow

    def _incr_cnt_dec(self, pos: int) -> None:
        # ANS.hx:680-696
        step = CX6_STEP << self.fshift
        self.cnts[pos] += step
        self.cntsum += step
        if pos > 0 and self.cnts[pos] > self.cnts[pos - 1]:
            for arr in (self.cnts, self.freq, self.cumfreq, self.symbols):
                arr[pos], arr[pos - 1] = arr[pos - 1], arr[pos]
        if self.cntsum + step > PROB_SCALE:
            self._rescale_dec()

    def upgrade(self, c: int) -> "Cx7":
        cx = Cx7()
        cx.create_from6(self, c)
        return cx


class Cx7(FixedSizeRansCtx):
    """Full-table context (ANS.hx:706-772)."""

    def __init__(self) -> None:
        super().__init__(256)

    def create_from3(self, c3: SymbList, c: int) -> None:
        # ANS.hx:711-739
        for i in range(256):
            self.freq[i] = 1
            self.cnts[i] = 1
        d = c3.d
        f0 = (PROB_SCALE - (256 - d)) // (d + 1)
        c0 = f0 - (f0 >> 1)
        for i in range(d):
            s = c3.symb[i]
            self.freq[s] = f0
            self.cnts[s] = c0
        self.freq[c] += f0
        self.cnts[c] += STEP_FX
        self.cntsum = 0
        cf = 0
        for i in range(256):
            self.cntsum += self.cnts[i]
            self.cumfreq[i] = cf
            fr = self.freq[i]
            _fill_dec_table(self.dec_table, cf, fr, i)
            cf += fr

    def create_from6(self, c6: Cx6, c: int) -> None:
        # ANS.hx:741-771 (the c arg is unused in the reference too)
        self.cntsum = c6.cntsum
        for i in range(c6.S):
            if c6.cnts[i] > 0:
                x = c6.symbols[i]
                self.freq[x] = c6.freq[i]
                self.cumfreq[x] = c6.cumfreq[i]
                self.cnts[x] = c6.cnts[i]
        funmet = 1 << c6.fshift
        cnt_unmet = funmet - (funmet >> 1)
        cum_fr = 0
        for i in range(256):
            if self.freq[i] > 0:
                fr = self.freq[i]
            else:
                self.freq[i] = funmet
                self.cumfreq[i] = cum_fr
                self.cnts[i] = cnt_unmet
                fr = funmet
            _fill_dec_table(self.dec_table, cum_fr, fr, i)
            cum_fr += fr


# ---------------------------------------------------------------------------
# Context dispatcher (ANS.hx:785-860)
# ---------------------------------------------------------------------------

K_NONE, K1, K2, K3, K4, K5, K6, K7 = range(8)


class Context:
    __slots__ = ("kind", "u", "f0_cx6")

    def __init__(self, f0_cx6: int = 32):
        self.kind = K_NONE
        self.u = None
        self.f0_cx6 = f0_cx6

    def renew(self) -> None:
        self.kind = K_NONE
        self.u = None

    def decode(self, some_freq: int) -> Optional[tuple]:
        """→ (c, freq, cumFreq) if a model handled it, None if the caller
        must read a raw byte then call update(c) (ANS.hx:795-810)."""
        k = self.kind
        if k == K6:
            rcv, handled = self.u.decode(some_freq)
            if not handled:
                self.u = self.u.upgrade(rcv[0])
                self.kind = K7
            return rcv
        if k == K7:
            return self.u.decode(some_freq)
        if k == K4:
            rcv, handled = self.u.decode(some_freq)
            if not handled:
                self.u = self.u.upgrade(rcv[0])
                self.kind = K5
            return rcv
        if k == K5:
            rcv, handled = self.u.decode(some_freq)
            if not handled:
                self.u = self.u.upgrade(rcv[0])
                self.u.f0 = self.f0_cx6
                self.kind = K6
            return rcv
        return None

    def encode(self, c: int) -> Optional[tuple]:
        """→ (freq, cumFreq) or None (emit raw byte + update)."""
        k = self.kind
        if k == K6:
            rcv, handled = self.u.encode(c)
            if not handled:
                self.u = self.u.upgrade(rcv[0])
                self.kind = K7
            return (rcv[1], rcv[2])
        if k == K7:
            fr, cf = self.u.encode(c)
            return (fr, cf)
        if k == K4:
            rcv, handled = self.u.encode(c)
            if not handled:
                self.u = self.u.upgrade(rcv[0])
                self.kind = K5
            return (rcv[1], rcv[2])
        if k == K5:
            rcv, handled = self.u.encode(c)
            if not handled:
                self.u = self.u.upgrade(rcv[0])
                self.u.f0 = self.f0_cx6
                self.kind = K6
            return (rcv[1], rcv[2])
        return None

    def update(self, c: int) -> None:
        # ANS.hx:812-829
        k = self.kind
        if k == K_NONE:
            self.u = make_cx1(c)
            self.kind = K1
        elif k == K1:
            self._update_c1(c)
        elif k == K2:
            self._update_c2(c)
        elif k == K3:
            self._update_c3(c)

    def _update_c1(self, c: int) -> None:
        # ANS.hx:831-839
        c1 = self.u
        res = c1.find_or_add(c)
        if res == FOUND:
            if c1.d <= 4:
                self.u = Cx4(c1, c)
                self.kind = K4
            else:
                self.u = Cx5.from_cx1(c1, c)
                self.kind = K5
        elif res == NOROOM:
            self.u = extend_list(c1, c, 64)
            self.kind = K2

    def _update_c2(self, c: int) -> None:
        # ANS.hx:841-849
        c2 = self.u
        res = c2.find_or_add(c)
        if res == FOUND:
            cx = Cx6(self.f0_cx6)
            cx.create_from2(c2, c)
            self.u = cx
            self.kind = K6
        elif res == NOROOM:
            self.u = extend_list(c2, c, 256)
            self.kind = K3

    def _update_c3(self, c: int) -> None:
        # ANS.hx:851-859
        c3 = self.u
        res = c3.find_or_add(c)
        if res == FOUND:
            cx = Cx7()
            cx.create_from3(c3, c)
            self.u = cx
            self.kind = K7

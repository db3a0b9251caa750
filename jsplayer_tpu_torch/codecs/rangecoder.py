"""Carry-aware range coder with adaptive frequency tables (ScreenPressor v2).

Decoder parity: RangeCoder.hx:5-131 — TOP=2^24, BOT=2^16, 5-byte init with the
first byte skipped (DecodeBegin, RangeCoder.hx:19-34), linear-scan DecodeVal
with +step adaptation and halve-renormalize (:51-80), and the two-level
16×16-bucket DecodeValUni over 273-entry tables (:82-130).

The encoder is new (the reference is decode-only): a classic carry-propagating
range encoder producing exactly the byte stream the reference decoder
consumes.  Layout invariant: the emitted stream is ``b"\\x00" + digits(N)``
where N = B·2^32 + low; the decoder's skipped first byte is the permanent
zero pad, so carries can never escape the payload (see RangeEncoder.finish).

All arithmetic is exact integer math — the reference runs on JS doubles but
every intermediate stays < 2^53, so Python ints match bit-for-bit.
"""

from __future__ import annotations

import numpy as np

TOP = 1 << 24
BOT = 1 << 16


class RangeDecoder:
    """RangeCoder.hx:5-131."""

    def __init__(self) -> None:
        self.range = 0
        self.code = 0
        self.data = b""
        self.pos = 0

    def decode_begin(self, src: bytes, pos0: int) -> None:
        # RangeCoder.hx:19-34 — byte at pos0 is skipped
        self.range = 0xFFFFFFFF
        self.data = src
        self.pos = pos0
        code = 0
        for k in range(1, 5):
            code = code * 256 + src[self.pos + k]
        self.code = code
        self.pos += 5

    def _decode(self, cum_freq: int, freq: int) -> None:
        # RangeCoder.hx:36-43 (range already divided by total in _get_freq)
        if freq == 0:
            # corrupt stream: a code value past every table entry exits the
            # symbol scans with freq 0 (decode_val_uni's bucket scan can
            # run to x==16, skipping the second loop entirely); range*0
            # would spin the renormalization below forever.  Clamp like
            # the native twin (spdec.cpp RangeDecoder::decode) so both
            # sides keep decoding — garbage pixels, never a hang.
            freq = 1
        self.code -= cum_freq * self.range
        self.range *= freq
        while self.range < TOP:
            self.code = self.code * 256 + (
                self.data[self.pos] if self.pos < len(self.data) else 0
            )
            self.pos += 1
            self.range *= 256

    def _get_freq(self, total_freq: int) -> int:
        # RangeCoder.hx:45-49
        self.range //= total_freq
        return self.code // self.range

    def decode_val(self, cnt: np.ndarray, off: int, maxc: int, step: int) -> int:
        """RangeCoder.DecodeVal (RangeCoder.hx:51-80) with table at cnt[off:]."""
        totfr = int(cnt[off + maxc])
        value = self._get_freq(totfr)
        c = 0
        cumfr = 0
        cnt_c = 0
        while c < maxc:
            cnt_c = int(cnt[off + c])
            if value >= cumfr + cnt_c:
                cumfr += cnt_c
            else:
                break
            c += 1
        self._decode(cumfr, cnt_c)
        _adapt_val(cnt, off, maxc, c, step, totfr)
        return c

    def decode_val_uni(self, cnt: np.ndarray, off: int, step: int) -> int:
        """RangeCoder.DecodeValUni (RangeCoder.hx:82-130): 16 bucket counts,
        total at off+16, 256 symbol counts at off+17..off+272."""
        totfr = int(cnt[off + 16])
        value = self._get_freq(totfr)
        x = 0
        cumfr = 0
        cnt_x = 0
        while x < 16:
            cnt_x = int(cnt[off + x])
            if value >= cumfr + cnt_x:
                cumfr += cnt_x
            else:
                break
            x += 1
        c = x * 16
        cnt_c = 0
        while c < 256:
            cnt_c = int(cnt[off + c + 17])
            if value >= cumfr + cnt_c:
                cumfr += cnt_c
            else:
                break
            c += 1
        self._decode(cumfr, cnt_c)
        _adapt_val_uni(cnt, off, c, x, step, totfr, cnt_c, cnt_x)
        return c


class RangeEncoder:
    """Carry-propagating encoder paired with RangeDecoder (new component)."""

    def __init__(self) -> None:
        self.low = 0
        self.range = 0xFFFFFFFF
        self.out = bytearray()

    def encode(self, cum_freq: int, freq: int, total_freq: int) -> None:
        r = self.range // total_freq
        self.low += cum_freq * r
        self.range = r * freq
        if self.low >= 1 << 32:
            self.low -= 1 << 32
            i = len(self.out) - 1
            while self.out[i] == 0xFF:
                self.out[i] = 0
                i -= 1
            self.out[i] += 1
        while self.range < TOP:
            self.out.append((self.low >> 24) & 0xFF)
            self.low = (self.low << 8) & 0xFFFFFFFF
            self.range <<= 8

    def finish(self) -> bytes:
        """Flush the 32-bit window; prepend the skipped pad byte
        (RangeCoder.hx:29 reads code starting at pos0+1)."""
        tail = bytes(
            [(self.low >> s) & 0xFF for s in (24, 16, 8, 0)]
        )
        return b"\x00" + bytes(self.out) + tail + b"\x00\x00\x00"

    def encode_val(self, cnt: np.ndarray, off: int, maxc: int, step: int,
                   c: int) -> None:
        """Encode symbol c against the adaptive table — mirror of decode_val."""
        totfr = int(cnt[off + maxc])
        cumfr = 0
        for i in range(c):
            cumfr += int(cnt[off + i])
        freq = int(cnt[off + c])
        self.encode(cumfr, freq, totfr)
        _adapt_val(cnt, off, maxc, c, step, totfr)

    def encode_val_uni(self, cnt: np.ndarray, off: int, step: int,
                       c: int) -> None:
        x = c >> 4
        totfr = int(cnt[off + 16])
        cumfr = 0
        for i in range(x):
            cumfr += int(cnt[off + i])
        for i in range(x * 16, c):
            cumfr += int(cnt[off + i + 17])
        freq = int(cnt[off + c + 17])
        self.encode(cumfr, freq, totfr)
        _adapt_val_uni(cnt, off, c, x, step, totfr, freq, int(cnt[off + x]))


def _adapt_val(cnt: np.ndarray, off: int, maxc: int, c: int, step: int,
               totfr: int) -> None:
    """Shared post-decode adaptation (RangeCoder.hx:68-79)."""
    cnt[off + c] = int(cnt[off + c]) + step
    totfr += step
    if totfr > BOT:
        totfr = 0
        for i in range(maxc):
            nc = (int(cnt[off + i]) >> 1) + 1
            cnt[off + i] = nc
            totfr += nc
    cnt[off + maxc] = totfr


def _adapt_val_uni(cnt: np.ndarray, off: int, c: int, x: int, step: int,
                   totfr: int, cnt_c: int, cnt_x: int) -> None:
    """Shared post-decode adaptation for the two-level table
    (RangeCoder.hx:110-129)."""
    cnt[off + c + 17] = cnt_c + step
    cnt[off + x] = cnt_x + step
    totfr += step
    if totfr > BOT:
        totfr = 0
        for i in range(off + 17, off + 256 + 17):
            nc = (int(cnt[i]) >> 1) + 1
            cnt[i] = nc
            totfr += nc
        for i in range(16):
            i16_17 = off + (i << 4) + 17
            s = 0
            for j in range(16):
                s += int(cnt[i16_17 + j])
            cnt[off + i] = s
    cnt[off + 16] = totfr

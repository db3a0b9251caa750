"""MSVideo1 (CRAM) encoders — fixture/stream generators.

The reference has no encoder or tests (SURVEY.md §4); these emit
spec-conformant streams whose decode semantics are fully determined by the
reference decoder (MSVideo1.hx:106-209 for 16-bit, :293-393 for 8-bit).

Opcode encoding constraints honored here (derived from the decoder's
dispatch, MSVideo1.hx:128-181):
  * second opcode byte ``b`` in 0x84..0x87 ⇒ skip-run;
  * ``b < 0x80`` ⇒ 2/8-color (16-bit: mode from clr0 bit15; 8-bit: 2-color);
  * 8-bit ``b >= 0x90`` ⇒ 8-color; other ``b >= 0x80`` ⇒ 1-color;
  * 8-bit ``a+b == 0`` ⇒ stream terminator, so 2-color flags may not be 0.

Because the flag word shares bytes with the opcode selector, painting flags
for the bottom row constrain which quadrant color plays the pal[...+1] role;
the per-quadrant role assignment below guarantees a representable opcode for
any block with ≤2 colors per 2×2 quadrant.
"""

from __future__ import annotations

import numpy as np


def to_rgb15(c: int) -> int:
    """Inverse of MSVideo1.from_rgb15 for colors on the RGB555 lattice."""
    return ((c >> 3) & 0x1F) | (((c >> 11) & 0x1F) << 5) | (((c >> 19) & 0x1F) << 10)


def _blocks(frame: np.ndarray, X: int, Y: int) -> np.ndarray:
    """[Y*X] → [NB, 16] in (by, bx, y, x) order."""
    return (
        frame.reshape(Y >> 2, 4, X >> 2, 4).transpose(0, 2, 1, 3).reshape(-1, 16)
    )


def _flush_skip(out: bytearray, skip: int) -> int:
    while skip > 0:
        take = min(skip, 0x3FF)
        out.append(take & 0xFF)
        out.append(0x84 + (take >> 8))
        skip -= take
    return 0


_BITPOS = np.arange(16, dtype=np.uint64)


def _pack_bits(bits: np.ndarray) -> int:
    return int((bits.astype(np.uint64) << _BITPOS).sum())


# ---------------------------------------------------------------------------
# 16-bit
# ---------------------------------------------------------------------------

def _emit_2color_16(out: bytearray, blk: np.ndarray) -> None:
    """16-bit 2-color. Decoder flags are emitted^0xFFFF and bit15 of the
    emitted word must be 0 (b<0x80) ⇒ pixel (3,3) must select pal[1]."""
    c1 = int(blk[15])
    rest = blk[blk != np.uint32(c1)]
    c0 = int(rest[0]) if rest.size else c1
    bits = (blk == np.uint32(c1)).astype(np.uint64)  # 1 → pal[1]
    emitted = _pack_bits(bits) ^ 0xFFFF
    assert emitted >> 8 < 0x80
    out.append(emitted & 0xFF)
    out.append(emitted >> 8)
    out += (to_rgb15(c0) & 0x7FFF).to_bytes(2, "little")  # bit15=0 ⇒ 2-color
    out += to_rgb15(c1).to_bytes(2, "little")


def _try_emit_8color_16(out: bytearray, blk: np.ndarray) -> bool:
    """16-bit 8-color: ≤2 colors per 2×2 quadrant (MSVideo1.hx:142-158).
    Emitted bit15 must be 0 ⇒ pixel (3,3) selects its quadrant's pal[.+1]."""
    b4 = blk.reshape(4, 4)
    pal = np.zeros(8, dtype=np.uint32)
    bits = np.zeros((4, 4), dtype=np.uint64)
    for qy in range(2):
        for qx in range(2):
            quad = b4[qy * 2 : qy * 2 + 2, qx * 2 : qx * 2 + 2]
            uniq = np.unique(quad)
            if len(uniq) > 2:
                return False
            base = (qy << 2) + (qx << 1)
            if qy == 1 and qx == 1:
                c1 = int(quad[1, 1])  # pixel (3,3) must map to role 1
                rest = uniq[uniq != np.uint32(c1)]
                c0 = int(rest[0]) if rest.size else c1
                q_sel = quad == np.uint32(c1) if rest.size else np.ones((2, 2), bool)
            else:
                c0 = int(uniq[0])
                c1 = int(uniq[1]) if len(uniq) > 1 else c0
                q_sel = quad == np.uint32(c1) if len(uniq) > 1 else np.zeros((2, 2), bool)
            pal[base], pal[base + 1] = c0, c1
            bits[qy * 2 : qy * 2 + 2, qx * 2 : qx * 2 + 2] = q_sel
    emitted = _pack_bits(bits.reshape(16)) ^ 0xFFFF
    if emitted >> 8 >= 0x80:
        return False  # cannot happen given the (3,3) role pin; keep safe
    out.append(emitted & 0xFF)
    out.append(emitted >> 8)
    out += (to_rgb15(int(pal[0])) | 0x8000).to_bytes(2, "little")  # 8-color flag
    for k in range(1, 8):
        out += to_rgb15(int(pal[k])).to_bytes(2, "little")
    return True


def encode_frame_16(
    frame: np.ndarray, prev: np.ndarray | None, X: int, Y: int
) -> bytes:
    """Encode one 16-bit CRAM frame. ``frame`` is u32[X*Y] with colors on the
    RGB555 lattice (i.e. produced by from_rgb15). Lossless iff every changed
    4×4 block has ≤2 colors per 2×2 quadrant."""
    out = bytearray()
    blocks = _blocks(frame, X, Y)
    pblocks = _blocks(prev, X, Y) if prev is not None else None
    skip = 0
    for bi in range(blocks.shape[0]):
        blk = blocks[bi]
        if pblocks is not None and (blk == pblocks[bi]).all():
            skip += 1
            continue
        skip = _flush_skip(out, skip)
        uniq = np.unique(blk)
        if len(uniq) == 1:
            c15 = to_rgb15(int(uniq[0])) | 0x8000  # b>=0x80 ⇒ 1-color
            b = c15 >> 8
            if (b & 0xFC) == 0x84:  # would read as skip-run: use 2-color form
                _emit_2color_16(out, blk)
            else:
                out.append(c15 & 0xFF)
                out.append(b)
        elif len(uniq) == 2:
            _emit_2color_16(out, blk)
        elif not _try_emit_8color_16(out, blk):
            raise ValueError("block not losslessly encodable in 16-bit CRAM")
    _flush_skip(out, skip)
    return bytes(out)


# ---------------------------------------------------------------------------
# 8-bit
# ---------------------------------------------------------------------------

def _emit_2color_8(out: bytearray, blk: np.ndarray) -> None:
    """8-bit 2-color: flags NOT inverted; bit k selects p2[bit] with
    p2[1]=pal[first byte], p2[0]=pal[second] (MSVideo1.hx:319-333).
    b<0x80 ⇒ flags bit15=0 ⇒ pixel (3,3) selects p2[0]."""
    c_p0 = int(blk[15])
    rest = blk[blk != np.uint32(c_p0)]
    c_p1 = int(rest[0]) if rest.size else c_p0
    bits = (blk == np.uint32(c_p1)).astype(np.uint64) if rest.size else np.zeros(16, np.uint64)
    flags = _pack_bits(bits)
    assert flags >> 8 < 0x80 and flags != 0  # ≠0: distinct colors guarantee a set bit
    out.append(flags & 0xFF)
    out.append(flags >> 8)
    out.append(c_p1)  # p2[1]
    out.append(c_p0)  # p2[0]


def _try_emit_8color_8(out: bytearray, blk: np.ndarray) -> bool:
    """8-bit 8-color needs emitted b ≥ 0x90 (MSVideo1.hx:336): with
    flags = emitted^0xFFFF, pin pixel (3,3) → role 0 and pixel (3,1) → role 0
    so the emitted high byte is ≥ 0xA0."""
    b4 = blk.reshape(4, 4)
    pal = np.zeros(8, dtype=np.uint32)
    bits = np.zeros((4, 4), dtype=np.uint64)
    for qy in range(2):
        for qx in range(2):
            quad = b4[qy * 2 : qy * 2 + 2, qx * 2 : qx * 2 + 2]
            uniq = np.unique(quad)
            if len(uniq) > 2:
                return False
            base = (qy << 2) + (qx << 1)
            if qy == 1:  # bottom quadrants: pixel (1,1) of quad → role 0
                c0 = int(quad[1, 1])
                rest = uniq[uniq != np.uint32(c0)]
                c1 = int(rest[0]) if rest.size else c0
                q_sel = quad == np.uint32(c1) if rest.size else np.zeros((2, 2), bool)
            else:
                c0 = int(uniq[0])
                c1 = int(uniq[1]) if len(uniq) > 1 else c0
                q_sel = quad == np.uint32(c1) if len(uniq) > 1 else np.zeros((2, 2), bool)
            pal[base], pal[base + 1] = c0, c1
            bits[qy * 2 : qy * 2 + 2, qx * 2 : qx * 2 + 2] = q_sel
    emitted = _pack_bits(bits.reshape(16)) ^ 0xFFFF
    if emitted >> 8 < 0x90:
        return False  # unreachable given the role pins; keep safe
    out.append(emitted & 0xFF)
    out.append(emitted >> 8)
    for k in range(8):
        out.append(int(pal[k]))
    return True


def encode_frame_8(
    frame_idx: np.ndarray, prev_idx: np.ndarray | None, X: int, Y: int,
    terminator: bool = False,
) -> bytes:
    """Encode one 8-bit CRAM frame from palette *indices* u8[X*Y]."""
    out = bytearray()
    blocks = _blocks(frame_idx.astype(np.uint32), X, Y)
    pblocks = (
        _blocks(prev_idx.astype(np.uint32), X, Y) if prev_idx is not None else None
    )
    skip = 0
    for bi in range(blocks.shape[0]):
        blk = blocks[bi]
        if pblocks is not None and (blk == pblocks[bi]).all():
            skip += 1
            continue
        skip = _flush_skip(out, skip)
        uniq = np.unique(blk)
        if len(uniq) == 1:
            out.append(int(uniq[0]))  # a = palette index
            out.append(0x80)  # 1-color opcode (b>=0x80, not skip, <0x90)
        elif len(uniq) == 2:
            _emit_2color_8(out, blk)
        elif not _try_emit_8color_8(out, blk):
            raise ValueError("block not losslessly encodable in 8-bit CRAM")
    _flush_skip(out, skip)
    if terminator:
        out += b"\x00\x00"
    return bytes(out)


# ---------------------------------------------------------------------------
# Property-based opcode fuzzers (oracle↔device parity tests)
# ---------------------------------------------------------------------------

def random_stream_16(rng: np.random.Generator, X: int, Y: int,
                     allow_skip: bool) -> bytes:
    nb = (X >> 2) * (Y >> 2)
    out = bytearray()
    bi = 0
    while bi < nb:
        op = int(rng.integers(0, 4)) if allow_skip else int(rng.integers(1, 4))
        if op == 0:
            run = int(rng.integers(1, min(nb - bi, 40) + 1))
            _flush_skip(out, run)
            bi += run
        elif op == 1:  # 1-color
            c15 = int(rng.integers(0, 0x8000)) | 0x8000
            if ((c15 >> 8) & 0xFC) == 0x84:
                c15 ^= 0x0300  # dodge skip encoding
            out.append(c15 & 0xFF)
            out.append(c15 >> 8)
            bi += 1
        elif op == 2:  # 2-color: emitted high byte < 0x80
            emitted = int(rng.integers(0, 1 << 15))
            out.append(emitted & 0xFF)
            out.append(emitted >> 8)
            out += int(rng.integers(0, 0x8000)).to_bytes(2, "little")  # clr0 bit15=0
            out += int(rng.integers(0, 0x10000)).to_bytes(2, "little")
            bi += 1
        else:  # 8-color: emitted high byte < 0x80, clr0 bit15=1
            emitted = int(rng.integers(0, 1 << 15))
            out.append(emitted & 0xFF)
            out.append(emitted >> 8)
            out += (int(rng.integers(0, 0x8000)) | 0x8000).to_bytes(2, "little")
            for _ in range(7):
                out += int(rng.integers(0, 0x10000)).to_bytes(2, "little")
            bi += 1
    return bytes(out)


def random_stream_8(rng: np.random.Generator, X: int, Y: int,
                    allow_skip: bool) -> bytes:
    nb = (X >> 2) * (Y >> 2)
    out = bytearray()
    bi = 0
    while bi < nb:
        op = int(rng.integers(0, 4)) if allow_skip else int(rng.integers(1, 4))
        if op == 0:
            run = int(rng.integers(1, min(nb - bi, 40) + 1))
            _flush_skip(out, run)
            bi += run
        elif op == 1:  # 1-color
            out.append(int(rng.integers(0, 256)))
            b = int(rng.integers(0x80, 0x90))
            if (b & 0xFC) == 0x84:
                b = 0x80
            out.append(b)
            bi += 1
        elif op == 2:  # 2-color: b<0x80, (a,b) != (0,0)
            flags = int(rng.integers(1, 1 << 15))
            out.append(flags & 0xFF)
            out.append(flags >> 8)
            out.append(int(rng.integers(0, 256)))
            out.append(int(rng.integers(0, 256)))
            bi += 1
        else:  # 8-color: b>=0x90
            out.append(int(rng.integers(0, 256)))
            out.append(int(rng.integers(0x90, 0x100)))
            for _ in range(8):
                out.append(int(rng.integers(0, 256)))
            bi += 1
    return bytes(out)

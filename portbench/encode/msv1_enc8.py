"""The 8-bit MSVideo1 (CRAM) encoder, frozen for the benchmark.

A copy of the 8-bit half of jsplayer_tpu_torch/encode/msv1_enc.py
(``encode_frame_8`` and its two emitters) as it stood when the benchmark
took an 8-bit codec, so a later change to the port's encoder cannot move
the benchmark's inputs.  The helpers both halves share (``_blocks``,
``_flush_skip``, ``_pack_bits``) are msv1_enc.py's frozen copies.  Its
notes, as there (MSVideo1.hx:293-393):

  * second opcode byte ``b`` in 0x84..0x87 ⇒ skip-run;
  * ``b < 0x80`` ⇒ 2-color; ``b >= 0x90`` ⇒ 8-color; other ``b >= 0x80``
    ⇒ 1-color;
  * ``a+b == 0`` ⇒ stream terminator, so 2-color flags may not be 0.
"""

from __future__ import annotations

import numpy as np

from .msv1_enc import _blocks, _flush_skip, _pack_bits


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

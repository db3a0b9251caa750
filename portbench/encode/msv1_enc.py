"""The 16-bit MSVideo1 (CRAM) encoder, frozen for the benchmark.

A copy of the 16-bit half of jsplayer_tpu_torch/encode/msv1_enc.py as it
stood when the benchmark was defined, so a later change to the port's
encoder cannot move the benchmark's inputs.  Its notes, as there:

Opcode encoding constraints honored here (derived from the decoder's
dispatch, MSVideo1.hx:128-181):
  * second opcode byte ``b`` in 0x84..0x87 ⇒ skip-run;
  * ``b < 0x80`` ⇒ 2/8-color (16-bit: mode from clr0 bit15);
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

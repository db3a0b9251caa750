"""Plain twins of the ds2 experiment kernels (ds_probe modes).

The Pallas experiments under ``scripts/`` (exp_pallas_ds.py,
exp_pallas_ds2.py, exp_pallas_bisect.py) cut a [C, Y, X] u32 frame stack
into blocks of BH rows (grid (C, ceil(Y/BH))) and write one output block
per input block.  Each function here computes what such a kernel computes,
on int32 bit-view tensors:

* the last input block is partial (1080 = 8*128 + 56): its rows past Y read
  as 0, as in Pallas interpret mode (on the TPU they are undefined);
* output shapes are exactly the scripts', padded block rows included;
* int32 sums wrap (added in int64, then folded back to 32 bits).

``MODES`` maps each mode of csrc/ds_probe.cu to its twin and output shape;
kernels/ds_probe.py launches the kernel.  Field sums pack the three 8-bit
channels as ``b | g << 10 | r << 20`` (a sum of four is at most 1020, so no
field carries into the next).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.rgb_convert import ds2_pack_ref


def pack_fields(c: torch.Tensor) -> torch.Tensor:
    """u32 pixels (int32 bits) → 10-bit fields b | g<<10 | r<<20 (the high
    byte is dropped)."""
    return ((c & 0xFF) | (((c >> 8) & 0xFF) << 10)
            | (((c >> 16) & 0xFF) << 20))


def wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 → int32 modulo 2**32 (two's complement)."""
    return (((x + 2**31) & 0xFFFFFFFF) - 2**31).to(torch.int32)


def nblocks(Y: int, BH: int) -> int:
    """Grid rows of BH-row blocks over Y rows (the last may be partial)."""
    return -(-Y // BH)


def padded(frames: torch.Tensor, BH: int) -> torch.Tensor:
    """[C, Y, X] → [C, nblocks*BH, X], rows past Y zero."""
    Y = frames.shape[-2]
    return F.pad(frames, (0, 0, 0, nblocks(Y, BH) * BH - Y))


def rw22(frames: torch.Tensor) -> torch.Tensor:
    """The 2×2 VALID box sums of the packed fields (exp_pallas_ds.rw22):
    [C, Y, X] → [C, Y//2, X//2].  Also the twin of mode ``ds2_fields``."""
    return ds2_pack_ref(frames, flip=False)


def bitcast_fold_ref(frames: torch.Tensor) -> torch.Tensor:
    """exp_pallas_ds ``bitcast``: the u16→u32 bitcast pairs ROWS, and the
    reshape [BH/2, X] → [BH/2, 2, X/2] then folds the right half of each row
    onto the left: out[r, c] = fields of rows 2r, 2r+1 at columns c and
    c + X/2, summed.  [C, Y, X] (X even) → [C, Y//2, X//2]."""
    Y, X = frames.shape[-2:]
    if X % 2:
        raise ValueError("bitcast_fold needs an even width")
    Ho, Wo = Y // 2, X // 2
    f = pack_fields(frames[..., : 2 * Ho, :])
    h = f[..., 0::2, :] + f[..., 1::2, :]
    return h[..., :Wo] + h[..., Wo:]


def passthru_ref(frames: torch.Tensor, BH: int = 128) -> torch.Tensor:
    """exp_pallas_ds2 ``passthru``: each block's top-left [BH/2, X/2] →
    [C, n*BH/2, X//2]."""
    p = padded(frames, BH)
    C, R, X = p.shape
    n = R // BH
    return p.reshape(C, n, BH, X)[:, :, : BH // 2, : X // 2].reshape(
        C, n * (BH // 2), X // 2)


def pack_h_ref(frames: torch.Tensor, BH: int = 128) -> torch.Tensor:
    """exp_pallas_ds2 ``pack_h``: packed row-pair sums, first X/2 columns
    → [C, n*BH/2, X//2]."""
    f = pack_fields(padded(frames, BH))
    X = f.shape[-1]
    return (f[:, 0::2] + f[:, 1::2])[..., : X // 2]


def sum4_ref(frames: torch.Tensor, BH: int = 128) -> torch.Tensor:
    """exp_pallas_ds2 ``tpose16_notr``: two row-pairing bitcasts with no
    transpose between them, so packed FOUR-row sums, first X/2 columns →
    [C, n*BH/4, X//2]."""
    f = pack_fields(padded(frames, BH))
    X = f.shape[-1]
    return (f[:, 0::4] + f[:, 1::4] + f[:, 2::4] + f[:, 3::4])[..., : X // 2]


def hpair_i32_ref(frames: torch.Tensor, BH: int = 128) -> torch.Tensor:
    """exp_pallas_bisect ``sub_slice``/``sub_reshape``/``sub_roll``: int32
    row-pair sums (wrapping) → [C, n*BH/2, X]."""
    p = padded(frames, BH).to(torch.int64)
    return wrap32(p[:, 0::2] + p[:, 1::2])


def hpair_lowbyte_ref(frames: torch.Tensor, BH: int = 128) -> torch.Tensor:
    """exp_pallas_bisect ``bitcast_h``: row-pair sums of the low byte →
    [C, n*BH/2, X]."""
    p = padded(frames, BH) & 0xFF
    return p[:, 0::2] + p[:, 1::2]


def wpair_i32_ref(frames: torch.Tensor, BH: int = 128) -> torch.Tensor:
    """exp_pallas_bisect ``minor_reshape``/``lane_gather_same``: int32
    column-pair sums (wrapping) → [C, n*BH, X//2]."""
    p = padded(frames, BH).to(torch.int64)
    Wo = p.shape[-1] // 2
    return wrap32(p[..., 0: 2 * Wo: 2] + p[..., 1: 2 * Wo: 2])


def block_transpose_ref(frames: torch.Tensor, BH: int = 128) -> torch.Tensor:
    """exp_pallas_bisect ``transpose``: each [BH, X] block transposed →
    [C, n*X, BH]."""
    p = padded(frames, BH)
    C, R, X = p.shape
    n = R // BH
    return p.reshape(C, n, BH, X).transpose(-1, -2).reshape(C, n * X, BH)


def _half(C, Y, X, BH):
    return (C, Y // 2, X // 2)


def _rows(num, den, cols):
    def shape(C, Y, X, BH):
        return (C, nblocks(Y, BH) * BH * num // den, cols(X, BH))
    return shape


#: mode → (id in csrc/ds_probe.cu, plain twin (frames, BH), output shape
#: (C, Y, X, BH)).  The ids are the kernel's Mode enum.
MODES = {
    "ds2_fields": (0, lambda f, BH: rw22(f), _half),
    "bitcast_fold": (1, lambda f, BH: bitcast_fold_ref(f), _half),
    "passthru": (2, passthru_ref, _rows(1, 2, lambda X, BH: X // 2)),
    "pack_h": (3, pack_h_ref, _rows(1, 2, lambda X, BH: X // 2)),
    "sum4": (4, sum4_ref, _rows(1, 4, lambda X, BH: X // 2)),
    "hpair_i32": (5, hpair_i32_ref, _rows(1, 2, lambda X, BH: X)),
    "hpair_lowbyte": (6, hpair_lowbyte_ref, _rows(1, 2, lambda X, BH: X)),
    "wpair_i32": (7, wpair_i32_ref, _rows(1, 1, lambda X, BH: X // 2)),
    "block_transpose": (8, block_transpose_ref,
                        lambda C, Y, X, BH: (C, nblocks(Y, BH) * X, BH)),
}


def probe_read_words(mode: str, C: int, Y: int, X: int,
                     BH: int = 128) -> int:
    """The input words the output of ds_probe `mode` depends on (rows past
    Y read 0 and come from no memory): what a call must read at least."""
    if mode == "passthru":  # each block's top-left [BH/2, X/2]
        rows = sum(min(BH // 2, Y - s) for s in range(0, Y, BH))
        return C * rows * (X // 2)
    if mode in ("pack_h", "sum4"):  # the first X/2 columns
        return C * Y * (X // 2)
    if mode in ("ds2_fields", "bitcast_fold"):  # complete 2x2 windows
        return C * (Y // 2 * 2) * (X // 2 * 2)
    if mode == "wpair_i32":  # complete column pairs
        return C * Y * (X // 2 * 2)
    return C * Y * X


def probe_ref(frames: torch.Tensor, mode: str, BH: int = 128) -> torch.Tensor:
    """The plain twin of ds_probe `mode` on [C, Y, X] frames."""
    return MODES[mode][1](frames, BH)


def probe_shape(mode: str, C: int, Y: int, X: int, BH: int = 128
                ) -> tuple[int, int, int]:
    """The output shape of ds_probe `mode` on [C, Y, X] frames."""
    return MODES[mode][2](C, Y, X, BH)

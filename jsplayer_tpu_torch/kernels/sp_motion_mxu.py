"""ScreenPressor motion compose, MXU layout — the port's counterpart of
jsplayer_tpu/kernels/sp_motion_mxu.py.

The JAX module's Pallas kernel (``_kernel``) over-fetches a tile-aligned
24×256 window of the previous frame per motion block and pulls the
unaligned 16×16 tile out of it with two one-hot f32 matmuls.  Here it is
mode "mxu" of the hand-written CUDA kernel csrc/sp_motion.cu
(``sp_motion_mxu``), one launch for all B streams, with no over-fetch, no
matmul and no padding helper.  Per pixel:

    is_motion[block]       -> prev[sy + i, sx + j], (sy, sx) = src_yx[block]
    (paycode >> 24) > 0    -> paycode & 0xFFFFFF
    otherwise              -> prev

A source outside the frame reads 0, as the reference's zero pad does for
the 8 rows and 128 columns it pads (past those its DMA is undefined).
The matmul is exact for 24-bit pixels, which is what decoded frames hold;
the kernel copies all 32 bits.  No ingest path runs this compose, in the
JAX package or here: ``mxu_commands`` builds its inputs from captured SP
commands the way the JAX package's tests and scripts/tpu_validate.py do.

Tensors on the CPU take the plain twin ``compose_frame_mxu_ref``; tensors
on the card launch the kernel or raise.  ``interpret`` is accepted for the
reference's signature and has no effect.
"""

from __future__ import annotations

import torch

from .sp_recon import (block_broadcast, block_grid, block_masks, cpu_result,
                       per_stream_ref, pixel_grid, read_or_zero,
                       launch_block_kernel)


def compose_frame_mxu_ref(prev, paycode, src_yx, is_motion) -> torch.Tensor:
    """Plain twin of one MXU compose: prev/paycode [Y, X] int32 bit views,
    src_yx [NB, 2] (sy, sx) and is_motion [NB] int32 → [Y, X]."""
    Y, X = prev.shape
    nby, nbx = block_grid(Y, X)
    base = torch.where(((paycode >> 24) & 0xFF) > 0, paycode & 0x00FFFFFF,
                       prev)
    yy, xx = pixel_grid(Y, X, prev.device)
    s = block_broadcast(src_yx, nby, nbx, Y, X)
    moved = read_or_zero(prev, s[..., 0].long() + (yy & 15),
                         s[..., 1].long() + (xx & 15))
    im = block_broadcast(is_motion, nby, nbx, Y, X) != 0
    return torch.where(im, moved, base)


def sp_motion_mxu(prev, paycode, src_yx, is_motion, changed, out=None):
    """One MXU-layout compose for every stream of a batch: prev/paycode
    [B, Y, X] int32 bit views, src_yx [B, NB, 2], is_motion [B, NB] int32,
    changed [B] bool → out [B, Y, X] (allocated unless given; it must not
    alias prev).  Unchanged streams copy prev.

    Mode "mxu" of csrc/sp_motion.cu for tensors on the card; the plain twin
    only for tensors on the CPU."""
    if prev.device.type == "cpu":
        return cpu_result(per_stream_ref(compose_frame_mxu_ref, prev,
                                         changed, paycode, src_yx, is_motion),
                          out)
    return launch_block_kernel(
        sp_motion_mxu, "jsp_sp_motion_mxu", prev, paycode,
        [("src_yx", src_yx, (2,)), ("is_motion", is_motion, ())], changed,
        out)


sp_motion_mxu.launches = 0  # kernel launches (the plain path does not count)


def compose_frame_mxu_safe(prev, paycode, src_yx, is_motion,
                           interpret=False):
    """The reference's signature: prev/paycode [Y, X], src_yx [NB, 2],
    is_motion [NB] → [Y, X]."""
    chg = torch.ones(1, dtype=torch.bool, device=prev.device)
    return sp_motion_mxu(prev[None], paycode[None], src_yx[None],
                         is_motion[None], chg)[0]


def mxu_commands(bts, mv, rect, payload):
    """One frame's captured SP commands (bts [NB], mv [NB, 2], rect
    [NB, 4] int32, payload [Y, X] int32 bits) → the MXU compose's inputs
    (paycode [Y, X], src_yx [NB, 2], is_motion [NB]): pixels of bts 1/2/4
    inside the rect are data (payload | 1 << 24), bts-3 blocks are motion
    from (by*16 + my, bx*16 + mx)."""
    Y, X = payload.shape
    _, _, b, in_rect = block_masks(bts, rect, Y, X)
    is_data = (b > 0) & (b != 3) & in_rect
    paycode = (payload & 0x00FFFFFF) | (is_data.to(torch.int32) << 24)
    _, nbx = block_grid(Y, X)
    blk = torch.arange(bts.shape[0], dtype=torch.int32, device=bts.device)
    src_yx = torch.stack([(blk // nbx) * 16 + mv[:, 1],
                          (blk % nbx) * 16 + mv[:, 0]], dim=-1)
    return paycode, src_yx, (bts == 3).to(torch.int32)

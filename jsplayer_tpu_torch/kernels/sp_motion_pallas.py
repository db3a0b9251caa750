"""ScreenPressor P-frame composition, fused layout — the port's counterpart
of jsplayer_tpu/kernels/sp_motion_pallas.py.

The JAX module runs an XLA select pass (payload where a data command
covers the pixel) and then a Pallas kernel (``_patch_kernel``) that copies
each full-block motion command's 16×16 source window from the previous
frame with tile-aligned DMAs, lane rotates and stripe read-modify-writes.
Here both are mode "fused" of ONE hand-written CUDA kernel,
csrc/sp_motion.cu (``sp_motion_patch``), one launch per scan step for all
B streams.  Per pixel:

    bts == 3                -> prev[by*16 + my + i, bx*16 + mx + j]  (whole block)
    bts > 0 and in the rect -> payload                               (bts 1/2/4)
    otherwise               -> prev

The TPU pad/crop (1080 → 1088 rows, X to a multiple of 128) is gone: the
kernel runs on the unpadded [Y, X] frame and writes only pixels inside it.
A motion source outside the frame reads 0 (the JAX kernel reads its pad
rows there, or clamps its DMA window).  The decoder rejects motion whose
source rect leaves the frame (codecs/screenpressor.py, native/spdec.cpp), so
on every stream it accepts the two agree bit for bit.

Tensors on the CPU take the plain twin ``compose_frame_fast_ref``; tensors
on the card launch the kernel or raise.  ``interpret`` is accepted for the
reference's signatures and has no effect: the tensors' device decides.
"""

from __future__ import annotations

import torch

from .sp_recon import (block_broadcast, block_grid, block_masks, cpu_result,
                       per_stream_ref, read_or_zero, scan_steps,
                       significance, launch_block_kernel)


def compose_frame_fast_ref(prev, bts, mv, rect, payload) -> torch.Tensor:
    """Plain twin of one fused compose: prev/payload [Y, X] int32 bit
    views, bts [NB], mv [NB, 2] (mx, my), rect [NB, 4] → [Y, X]."""
    Y, X = prev.shape
    yy, xx, b, in_rect = block_masks(bts, rect, Y, X)
    base = torch.where((b > 0) & (b != 3) & in_rect, payload, prev)
    m = block_broadcast(mv, *block_grid(Y, X), Y, X)
    # by*16 + my + i == y + my: the block's source window, pixel by pixel
    moved = read_or_zero(prev, yy.long() + m[..., 1], xx.long() + m[..., 0])
    return torch.where(b == 3, moved, base)


def sp_motion_patch(prev, bts, mv, rect, payload, changed, out=None):
    """One fused scan step for every stream of a batch: prev/payload
    [B, Y, X] int32 bit views, bts [B, NB], mv [B, NB, 2], rect [B, NB, 4]
    int32, changed [B] bool → out [B, Y, X] (allocated unless given; it
    must not alias prev).  Unchanged streams copy prev and their commands
    are not read.

    Mode "fused" of csrc/sp_motion.cu for tensors on the card; the plain
    twin only for tensors on the CPU."""
    if prev.device.type == "cpu":
        return cpu_result(per_stream_ref(compose_frame_fast_ref, prev,
                                         changed, bts, mv, rect, payload),
                          out)
    return launch_block_kernel(
        sp_motion_patch, "jsp_sp_motion_patch", prev, payload,
        [("bts", bts, ()), ("mv", mv, (2,)), ("rect", rect, (4,))], changed,
        out)


sp_motion_patch.launches = 0  # kernel launches (the plain path does not count)


def compose_frame_fast(prev, bts, mv, rect, payload, interpret=False):
    """The reference's signature: prev/payload [Y, X], bts [NB], mv
    [NB, 2], rect [NB, 4] → [Y, X]."""
    chg = torch.ones(1, dtype=torch.bool, device=prev.device)
    return sp_motion_patch(prev[None], bts[None], mv[None], rect[None],
                           payload[None], chg)[0]


def decode_batch_fused(init_frames, bts, mv, rect, payload, changed,
                       insignificant_blocks, interpret=False):
    """Batched fused decode: init [B,Y,X], bts [B,T,NB], mv [B,T,NB,2],
    rect [B,T,NB,4], payload [B,T,Y,X], changed [B,T] → (frames
    [B,T,Y,X], signif [B,T]).  One launch per step over all B (the
    reference unrolls over streams)."""
    frames = scan_steps(sp_motion_patch, init_frames,
                        (bts, mv, rect, payload), changed)
    return frames, significance(bts, changed, insignificant_blocks)


def decode_sequence_fused(init_frame, bts, mv, rect, payload, changed,
                          insignificant_blocks, interpret=False):
    """One stream: init [Y,X], bts [T,NB], … → (frames [T,Y,X],
    signif [T])."""
    frames, signif = decode_batch_fused(
        init_frame[None], bts[None], mv[None], rect[None], payload[None],
        changed[None], insignificant_blocks)
    return frames[0], signif[0]

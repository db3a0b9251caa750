"""MSVideo1 block paint on torch: the port's device stage for MSV1 windows.

Counterpart of jsplayer_tpu/kernels/msv1_paint.py.  The host parses each
frame's opcodes into per-block commands (codecs/msvideo1.parse_commands or
the native twin): btype [NB] u8 (0 keep, >0 paint), sel [Y, X] u8 palette
indices in plane order (``sel_to_plane``), colors [NB, 8] u32.  A step
paints every block with btype > 0: each pixel whose index is below 8 takes
that colour, the others keep the step before's pixel.  The significance of
a step (MSVideo1.hx:187-204): some painted block row at or past
`insignificant_blocks`, confirmed, when a previous frame exists, by a pixel
that changed at or below `insign_lines`; then and-ed with the host's
`changes`, and a stream has a previous frame once any step changed.

``msv1_paint`` runs a whole window of B streams: csrc/msv1_paint.cu for
tensors on the card (ONE launch: MSV1 has no motion, so the time loop runs
inside the kernel, each pixel carried in a register; its staged instance
copies a warp's commands into shared memory ahead of the loop, its scalar
one takes unaligned views), its plain twin
``msv1_paint_ref`` (``paint_frame_ref`` step by step) for tensors on the
CPU.  It returns the frames and each step's pixel-diff flag; the block-row
half and the combine are torch ops on [B, T] (``signif_from``).  The
reference's ``decode_sequence``, ``decode_batch``,
``_decode_sequence_novmap``, ``paint_frame`` (a one-step window) and
``significant_changes`` keep their names and signatures over it.

u32 words (colours, frames) are int32 tensors holding the bits (device.py).
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from .. import _build
from ..device import cuda_launch_checks
from .sp_recon import cpu_result


def sel_to_plane(sel, Y: int, X: int):
    """Host helper: [..., NB, 16] block-ordered palette indices → [..., Y,
    X] plane order.  Works on numpy arrays or torch tensors."""
    lead = tuple(sel.shape[:-2])
    nby, nbx = Y // 4, X // 4
    x = sel.reshape(*lead, nby, nbx, 4, 4)
    if isinstance(sel, torch.Tensor):
        x = torch.movedim(x, -2, -3)
    else:
        x = np.moveaxis(x, -2, -3)
    return x.reshape(*lead, Y, X)


def _block_map(vals: torch.Tensor, Y: int, X: int) -> torch.Tensor:
    """Per-block values [NB, ...] of the 4x4 grid → per pixel [Y, X, ...]."""
    nby, nbx = Y // 4, X // 4
    tail = tuple(vals.shape[1:])
    v = vals.reshape((nby, 1, nbx, 1) + tail)
    return v.expand((nby, 4, nbx, 4) + tail).reshape((Y, X) + tail)


def paint_frame_ref(prev, btype, sel_plane, colors) -> torch.Tensor:
    """Plain twin of the reference's paint_frame, its ops one for one: prev
    [Y, X] int32 bit view, btype [NB] u8, sel_plane [Y, X] u8, colors
    [NB, 8] → [Y, X]: a painted block's pixel with index k < 8 takes colour
    k."""
    Y, X = prev.shape
    paint = _block_map(btype > 0, Y, X)
    out = prev
    for k in range(8):
        ck = _block_map(colors[:, k], Y, X)
        out = torch.where(paint & (sel_plane == k), ck, out)
    return out


def significant_changes_ref(dst, prev, prev_valid, btype,
                            insignificant_blocks, insign_lines,
                            nbx: int) -> torch.Tensor:
    """Plain twin of the reference's significant_changes: dst/prev [Y, X],
    prev_valid bool, btype [NB] → 0-d bool."""
    Y, X = dst.shape
    nby = Y // 4
    row_changed = (btype.reshape(nby, nbx) > 0).any(dim=1)
    rows = torch.arange(nby, device=btype.device)
    signif = (row_changed & (rows >= int(insignificant_blocks))).any()
    lines = torch.arange(Y, device=dst.device)
    line_mask = (lines >= int(insign_lines))[:, None]
    pixel_diff = ((dst != prev) & line_mask).any()
    return torch.where(torch.as_tensor(prev_valid, device=dst.device),
                       signif & pixel_diff, signif)


#: the reference's significant_changes (XLA there): torch ops on whichever
#: device the tensors lie, so the plain twin is the function itself
significant_changes = significant_changes_ref


def paint_frame(prev, btype, sel_plane, colors) -> torch.Tensor:
    """The reference's paint_frame: prev [Y, X] int32 bit view, btype [NB]
    u8, sel_plane [Y, X] u8, colors [NB, 8] int32 → [Y, X].  A one-step
    msv1_paint window: csrc/msv1_paint.cu on the card, paint_frame_ref on
    the CPU."""
    frames, _ = msv1_paint(prev[None], btype[None, None],
                           sel_plane[None, None], colors[None, None], 0)
    return frames[0, 0]


def msv1_paint_ref(init, btype, sel, colors, insign_lines
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of msv1_paint: paint_frame_ref step after step for each
    stream → (frames [B, T, Y, X], diff [B, T] bool: a pixel at y >=
    insign_lines changed at that step)."""
    B, T = btype.shape[:2]
    Y, X = init.shape[-2:]
    frames = torch.empty((B, T, Y, X), dtype=torch.int32, device=init.device)
    diff = torch.zeros((B, T), dtype=torch.bool, device=init.device)
    lines = (torch.arange(Y, device=init.device) >= int(insign_lines))[:, None]
    for b in range(B):
        prev = init[b]
        for t in range(T):
            dst = paint_frame_ref(prev, btype[b, t], sel[b, t], colors[b, t])
            diff[b, t] = ((dst != prev) & lines).any()
            frames[b, t] = dst
            prev = dst
    return frames, diff


def msv1_paint(init: torch.Tensor, btype: torch.Tensor, sel: torch.Tensor,
               colors: torch.Tensor, insign_lines: int,
               out: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """A whole MSV1 window of B streams: init [B, Y, X] int32 bit views (Y,
    X multiples of 4), btype [B, T, NB] u8, sel [B, T, Y, X] u8 (plane
    order), colors [B, T, NB, 8] int32 → (frames [B, T, Y, X] int32, written
    into `out` when given; diff [B, T] bool).  Every step paints; `changes`
    enters only the significance (signif_from).

    CUDA kernel csrc/msv1_paint.cu for tensors on the card — ONE launch for
    the window and all B streams; the plain twin only for tensors on the
    CPU.  Each argument may be a strided view whose rows (a step's [Y, X]
    or [NB, 8]) are contiguous."""
    if init.device.type == "cpu":
        frames, diff = msv1_paint_ref(init, btype, sel, colors, insign_lines)
        return cpu_result(frames, out), diff
    what = "msv1_paint"
    B, Y, X = init.shape
    T = btype.shape[1] if btype.dim() == 3 else -1
    if out is None:
        out = torch.empty((B, max(T, 0), Y, X), dtype=torch.int32,
                          device=init.device)
    cuda_launch_checks(what, init, colors, out)
    if Y % 4 or X % 4:
        raise ValueError(f"{what}: MSV1 frames are whole 4x4 blocks, got "
                         f"{Y}x{X}")
    nb = (Y // 4) * (X // 4)
    for name, t, shape in (("btype", btype, (B, T, nb)),
                           ("sel", sel, (B, T, Y, X))):
        if t.device != init.device or t.dtype != torch.uint8:
            raise TypeError(f"{what}: {name} must be a uint8 tensor on the "
                            f"frames' device, got {t.dtype} on {t.device}")
        if tuple(t.shape) != shape or t.stride(-1) != 1 or (
                name == "sel" and t.stride(-2) != X):
            raise ValueError(f"{what}: {name} must be {list(shape)} with "
                             f"contiguous rows, got {tuple(t.shape)} strides "
                             f"{t.stride()}")
    for name, t, shape in (("init", init, (B, Y, X)),
                           ("out", out, (B, T, Y, X))):
        if (tuple(t.shape) != shape or t.stride(-1) != 1
                or t.stride(-2) != X):
            raise ValueError(f"{what}: {name} must be row-contiguous "
                             f"{list(shape)}, got {tuple(t.shape)} strides "
                             f"{t.stride()}")
    if tuple(colors.shape) != (B, T, nb, 8) or colors.stride(-1) != 1 or (
            colors.stride(-2) != 8):
        raise ValueError(f"{what}: colors must be [{B}, {T}, {nb}, 8] with "
                         f"contiguous rows, got {tuple(colors.shape)}")
    diff = torch.empty((B, T), dtype=torch.int32, device=init.device)
    if B and T and Y and X:
        lib = _build.load()
        instance = MSV1_INSTANCES[lib.jsp_msv1_paint_instance(
            init.data_ptr(), init.stride(0), sel.data_ptr(), sel.stride(0),
            sel.stride(1), colors.data_ptr(), colors.stride(0),
            colors.stride(1), out.data_ptr(), out.stride(0), out.stride(1))]
        with torch.cuda.device(init.device):
            rc = lib.jsp_msv1_paint(
                init.data_ptr(), init.stride(0), btype.data_ptr(),
                btype.stride(0), btype.stride(1), sel.data_ptr(),
                sel.stride(0), sel.stride(1), colors.data_ptr(),
                colors.stride(0), colors.stride(1), out.data_ptr(),
                out.stride(0), out.stride(1), diff.data_ptr(), B, T, Y, X,
                int(insign_lines),
                torch.cuda.current_stream(init.device).cuda_stream)
        _build.check(rc, what)
        msv1_paint.launches += 1
        msv1_paint.by_instance[instance] += 1
        msv1_paint.last_instance = instance
    else:
        diff.zero_()
    return out, diff != 0


#: the kernel's instances, by jsp_msv1_paint_instance's answer: commands
#: staged in shared memory (16-byte init and frames, 4-byte sel, 8-byte
#: colour pairs), or loads from device memory every step
MSV1_INSTANCES = ("scalar", "staged")
msv1_paint.launches = 0  # kernel launches (the plain path does not count)
# the launches per instance, and the instance of the last one
msv1_paint.by_instance = collections.Counter()
msv1_paint.last_instance = None


def signif_from(btype, changes, init_valid, diff, insignificant_blocks,
                nbx: int) -> torch.Tensor:
    """The scan's significance from its pixel-diff flags: btype [B, T, NB],
    changes [B, T] bool, init_valid [B] bool, diff [B, T] bool → [B, T]
    bool.  A step's `valid` is init_valid or any earlier step's change (the
    reference's scan carry)."""
    B, T, nb = btype.shape
    rows = (btype.reshape(B, T, nb // nbx, nbx) > 0).any(dim=-1)
    above = torch.arange(nb // nbx, device=btype.device) >= \
        int(insignificant_blocks)
    signif = (rows & above).any(dim=-1)
    before = torch.cumsum(changes.to(torch.int32), dim=1) - \
        changes.to(torch.int32)
    valid = init_valid.reshape(B, 1) | (before > 0)
    return torch.where(valid, signif & diff, signif) & changes


def decode_batch(init_frames, init_valid, btype, sel, colors, changes,
                 insignificant_blocks, insign_lines, nbx: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched multi-stream decode: init_frames [B, Y, X], init_valid [B]
    bool, btype [B, T, NB] u8, sel [B, T, Y, X] u8 (plane order), colors
    [B, T, NB, 8], changes [B, T] bool → (frames [B, T, Y, X], signif
    [B, T] bool); one msv1_paint launch."""
    frames, diff = msv1_paint(init_frames, btype, sel, colors, insign_lines)
    return frames, signif_from(btype, changes, init_valid, diff,
                               insignificant_blocks, nbx)


def _decode_sequence_novmap(init_frame, init_valid, btype, sel, colors,
                            changes, insignificant_blocks, insign_lines,
                            nbx: int):
    """One stream: init_frame [Y, X], init_valid bool, btype [T, NB], sel
    [T, Y, X], colors [T, NB, 8], changes [T] → (frames [T, Y, X], signif
    [T])."""
    valid = torch.as_tensor(init_valid, dtype=torch.bool,
                            device=init_frame.device).reshape(1)
    frames, signif = decode_batch(
        init_frame[None], valid, btype[None], sel[None], colors[None],
        changes[None], insignificant_blocks, insign_lines, nbx)
    return frames[0], signif[0]


decode_sequence = _decode_sequence_novmap

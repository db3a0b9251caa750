"""Batched multi-stream decode: host command assembly and the sharded
device steps over the (dp, gop) mesh.

Counterpart of jsplayer_tpu/pipeline/batch.py.  ``stack_msv1_commands``
and ``stack_sp_commands`` are copies of the reference's host stage (that
module imports jax at the top, which the port never does), pinned by
their source text and outputs (tests/test_torch_batch.py,
tests/test_torch_validate.py).  The device half: each ``make_*_step``
returns a step over [B, G, T, ...] command stacks (B streams, G
keyframe-led segments, T frames a segment; numpy arrays or tensors) that
runs, on every slot of the mesh (pipeline/mesh.run_bg), the port's
batched decode of the slot's (b, g) rows flattened into one batch — one
kernel launch a scan step a slot (kmv_compose, bc_compose,
sp_compose_general), one msv1_paint launch a window a slot — and the
model epilogue, and returns the [B, G, T, ...] result on the mesh's
device (under several processes, this process's rows).  B or G that the
mesh does not divide raise ValueError.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..codecs import msvideo1 as msv1
from ..codecs.screenpressor import ScreenPressor
from ..kernels import msv1_paint, sp_recon
from ..kernels.rgb_convert import to_model_input
from .mesh import Mesh, run_bg


# ---------------------------------------------------------------------------
# Host command assembly
# ---------------------------------------------------------------------------

def stack_msv1_commands(
    streams: list[list[bytes]], X: int, Y: int,
    pal: Optional[np.ndarray] = None, gops: int = 1,
) -> dict[str, np.ndarray]:
    """Parse per-frame MSV1 opcode streams into [B, G, T, ...] command stacks.
    Every stream must have the same frame count, divisible by `gops`."""
    B = len(streams)
    T_total = len(streams[0])
    assert all(len(s) == T_total for s in streams)
    assert T_total % gops == 0
    Tg = T_total // gops
    nb = (X >> 2) * (Y >> 2)
    bt = np.zeros((B, T_total, nb), dtype=np.uint8)
    sel = np.zeros((B, T_total, nb, 16), dtype=np.uint8)
    col = np.zeros((B, T_total, nb, 8), dtype=np.uint32)
    chg = np.zeros((B, T_total), dtype=bool)
    from .. import native as _native

    nat_parse = _native.native_msv1_parse if _native.available() else None
    for b, frames in enumerate(streams):
        for t, src in enumerate(frames):
            parse = nat_parse or msv1.parse_commands
            bt[b, t], sel[b, t], col[b, t], chg[b, t] = parse(
                src, X, Y, pal=pal
            )
    rs = lambda a: a.reshape(B, gops, Tg, *a.shape[2:])
    # sel ships plane-ordered [.., Y, X] (device-side 4x4 relayout is 2x
    # the paint kernel's cost on TPU — msv1_paint.sel_to_plane)
    return dict(btype=rs(bt), sel=rs(msv1_paint.sel_to_plane(sel, Y, X)),
                colors=rs(col), changes=rs(chg))


def stack_sp_commands(
    streams: list[list[bytes]], X: int, Y: int, bpp: int = 24, gops: int = 1,
    insignificant_lines: int = 0,
) -> dict[str, np.ndarray]:
    """Run the SP host stage (entropy decode + command capture) over per-frame
    streams → [B, G, T, ...] stacks for kernels/sp_recon.  When gops > 1,
    each GOP must start with an I-frame (keyframe-delimited segments)."""
    B = len(streams)
    T_total = len(streams[0])
    assert T_total % gops == 0
    Tg = T_total // gops
    nbx, nby = (X + 15) // 16, (Y + 15) // 16
    nb = nbx * nby
    bts = np.zeros((B, T_total, nb), dtype=np.int32)
    mv = np.zeros((B, T_total, nb, 2), dtype=np.int32)
    rect = np.zeros((B, T_total, nb, 4), dtype=np.int32)
    payload = np.zeros((B, T_total, Y, X), dtype=np.uint32)
    changed = np.zeros((B, T_total), dtype=bool)
    from .. import native as _native

    if _native.available():
        # one parallel native call decodes all streams (thread pool = the
        # host-side DP axis)
        got = _native.native_sp_decode_streams(
            streams, X, Y, bpp=bpp, insignificant_lines=insignificant_lines)
        rs = lambda a: a.reshape(B, gops, Tg, *a.shape[2:])
        return dict(bts=rs(got["bts"]), mv=rs(got["mv"]), rect=rs(got["rect"]),
                    payload=rs(got["payload"]), changed=rs(got["changed"]))

    for b, frames in enumerate(streams):
        dec = ScreenPressor(X, Y, bpp)
        dec.preinit(insignificant_lines)
        for t, src in enumerate(frames):
            cap: dict = {}
            dec.capture = cap
            dst = np.zeros(X * Y, dtype=np.uint32)
            if dec.is_key_frame(src):
                dec.decompress_i(src, dst)
            else:
                dec.decompress_p(src, dst)
            bts[b, t] = cap["bts"]
            mv[b, t] = cap["mv"]
            rect[b, t] = cap["rect"]
            changed[b, t] = cap["changed"]
            data = dec.previous_frame()
            if data is not None:
                payload[b, t] = data.reshape(Y, X)
    rs = lambda a: a.reshape(B, gops, Tg, *a.shape[2:])
    return dict(bts=rs(bts), mv=rs(mv), rect=rs(rect), payload=rs(payload),
                changed=rs(changed))


# ---------------------------------------------------------------------------
# Sharded device decode
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DecodeConfig:
    height: int
    width: int
    insignificant_blocks: int = 0
    insignificant_lines: int = 0
    emit_model_input: bool = False
    model_dtype: str = "bfloat16"  # a torch dtype name
    bpp16: bool = False


def _epilogue(frames: torch.Tensor, cfg: DecodeConfig) -> torch.Tensor:
    if not cfg.emit_model_input:
        return frames
    return to_model_input(frames, dtype=getattr(torch, cfg.model_dtype),
                          bpp16=cfg.bpp16)


def make_msv1_decode_step(mesh: Mesh, cfg: DecodeConfig,
                          with_carry: bool = False):
    """The sharded step for MSV1 command stacks: btype, sel (plane
    order), colors, changes [B, G, T, ...] → (frames or model tensors
    [B, G, T, ...], signif [B, G, T]); one msv1_paint launch a slot.
    Default: every row starts from a zero frame with no valid previous
    frame (each row starts at a keyframe).  with_carry=True adds leading
    init [B, G, Y, X] u32 and valid [B, G] bool inputs, so that a window
    pipeline threads the previous window's last frame through."""
    nbx = cfg.width // 4

    def decode(init, valid, btype, sel, colors, changes):
        frames, signif = msv1_paint.decode_batch(
            init, valid, btype, sel, colors, changes,
            cfg.insignificant_blocks, cfg.insignificant_lines, nbx)
        return _epilogue(frames, cfg), signif

    if with_carry:
        return lambda *arrays: run_bg(mesh, decode, *arrays)

    def per_slot(btype, sel, colors, changes):
        n = btype.shape[0]
        init = torch.zeros((n, cfg.height, cfg.width), dtype=torch.int32,
                           device=btype.device)
        valid = torch.zeros(n, dtype=torch.bool, device=btype.device)
        return decode(init, valid, btype, sel, colors, changes)

    return lambda *arrays: run_bg(mesh, per_slot, *arrays)


def make_sp_decode_step_kmv(mesh: Mesh, cfg: DecodeConfig):
    """The production sharded SP step, kmv transport: init [B, G, Y, X]
    (zeros where every row starts at a keyframe), paycode [B, G, T, Y, X]
    u32, mvk [B, G, T, K, 2], changed [B, G, T] → frames or model tensors
    [B, G, T, ...]; one kmv_compose launch a scan step a slot.
    Significance comes from the host stage beside the transport."""

    def per_slot(init, paycode, mvk, changed):
        return _epilogue(sp_recon.decode_batch_kmv(init, paycode, mvk,
                                                   changed), cfg)

    return lambda *arrays: run_bg(mesh, per_slot, *arrays)


def make_sp_decode_step_bc(mesh: Mesh, cfg: DecodeConfig):
    """The sharded SP step, bc transport: init [B, G, Y, X] u32, plane
    [B, G, T, Y, X] u32, bcode [B, G, T, NB] u8, rloc [B, G, T, NB, 4] u8,
    mvk [B, G, T, K, 2], changed [B, G, T] → [B, G, T, ...]; one
    bc_compose launch a scan step a slot."""

    def per_slot(init, plane, bcode, rloc, mvk, changed):
        return _epilogue(sp_recon.decode_batch_bc(init, plane, bcode, rloc,
                                                  mvk, changed), cfg)

    return lambda *arrays: run_bg(mesh, per_slot, *arrays)


def make_sp_decode_step(mesh: Mesh, cfg: DecodeConfig):
    """The sharded step for captured SP command stacks: bts, mv, rect,
    payload, changed [B, G, T, ...] → (frames or model tensors, signif
    [B, G, T]), every row from a zero frame; one sp_compose_general launch
    a scan step a slot."""

    def per_slot(bts, mv, rect, payload, changed):
        init = torch.zeros_like(payload[:, 0])
        frames, signif = sp_recon.decode_batch(
            init, bts, mv, rect, payload, changed, cfg.insignificant_blocks)
        return _epilogue(frames, cfg), signif

    return lambda *arrays: run_bg(mesh, per_slot, *arrays)

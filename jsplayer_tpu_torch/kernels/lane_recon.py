"""Lane-container decode on torch: payload units, unique rows, the scan.

Counterpart of jsplayer_tpu/kernels/lane_recon.py (one window of one
stream, or B streams of shared bucket shapes):

  1. the payload units [U, 128] u32, by payload mode (codecs/lane_format):
     raw, the wire's byte-plane triplets [U, 3, 128] combined; rans, the
     renorm-aligned rANS decode (kernels/rans_lanes, csrc/rans_lanes.cu)
     of the same byte-plane symbols, then the same combine;
  2. rows_from_units: the window's unique data rows rows_unique [Ur, X],
     one gather of units through row_table;
  3. the scan over frames: each step gathers its data rows by row_idx and
     composes with the block codes, rects and K wrapping motion rolls.

Steps 1 and 2 are torch ops, as they were plain XLA outside the scan in
the reference.  Step 3's step is ``lane_compose``: csrc/bc_compose.cu's
lane instance for tensors on the card, one launch for all B streams,
and the plain twin ``lane_compose_ref`` for tensors on the CPU.

The reference's gathers (``jnp.take``) wrap an index in [-n, -1] and read
0xFFFFFFFF for any other index outside [0, n); ``take_rows`` (kept in
sp_recon.py, which the sparse tile gather shares) and the kernel do the
same.  A data pixel takes its row word as it is: no 0xFFFFFF mask
(compose_frame_lane's ``tp`` is unmasked, unlike compose_frame_bc's).
u32 words are int32 tensors holding the bits (device.py).
"""

from __future__ import annotations

import torch

from .. import _build
from ..device import cuda_launch_checks
from . import rans_lanes
from .sp_recon import (block_code_checks, compose_codes_ref, cpu_result,
                       per_stream_ref, scan_steps, step_checks, take_rows)


def units_from_raw(payload: torch.Tensor) -> torch.Tensor:
    """Raw payload mode: [..., U, 3, 128] uint8 byte planes → [..., U, 128]
    int32 units (byte0 | byte1 << 8 | byte2 << 16)."""
    m = payload.to(torch.int32)
    return m[..., 0, :] | (m[..., 1, :] << 8) | (m[..., 2, :] << 16)


def units_from_pack(refills, states, freq, U: int) -> torch.Tensor:
    """Lane decode + per-unit byte-triplet unpack → [U, 128] units.  Unit u's
    bytes live at flat[384*u:], so any padded U is correct."""
    syms = rans_lanes.decode_lanes_aligned(refills, states, freq)
    return units_from_raw(syms.reshape(-1)[: U * 384].reshape(U, 3, 128))


def rows_from_units(units: torch.Tensor, row_table: torch.Tensor,
                    X: int) -> torch.Tensor:
    """units [U, 128] + row_table [Ur, ncol] int32 → rows_unique [Ur, X]: the
    [:, :X] view of the assembled [Ur, ncol*128] rows."""
    Ur, ncol = row_table.shape
    rows = take_rows(units, row_table.reshape(-1))
    return rows.reshape(Ur, ncol * 128)[:, :X]


def compose_frame_lane_ref(prev, rows_unique, row_idx, btype, rect, mvk):
    """Plain twin of the reference's compose_frame_lane: prev [Y, X],
    rows_unique [Ur, X], row_idx [Y] int32, btype [NB] u8, rect [NB, 4] u8
    block-local, mvk [K, 2] → [Y, X].  The row gather, unmasked, is the
    data of sp_recon.compose_codes_ref."""
    return compose_codes_ref(prev, take_rows(rows_unique, row_idx), btype,
                             rect, mvk)


def lane_compose_ref(prev, rows, row_idx, bcode, rloc, mvk, changed):
    """Plain twin of the batched lane step: prev [B, Y, X], rows [B, Ur, X],
    row_idx [B, Y], bcode [B, NB], rloc [B, NB, 4], mvk [B, K, 2], changed
    [B] → [B, Y, X] (unchanged streams copy prev)."""
    return per_stream_ref(compose_frame_lane_ref, prev, changed, rows,
                          row_idx, bcode, rloc, mvk)


def lane_compose(prev: torch.Tensor, rows: torch.Tensor,
                 row_idx: torch.Tensor, bcode: torch.Tensor,
                 rloc: torch.Tensor, mvk: torch.Tensor,
                 changed: torch.Tensor, out: torch.Tensor | None = None
                 ) -> torch.Tensor:
    """One lane scan step for every stream of a batch: prev [B, Y, X] int32
    bit views, rows [B, Ur, X] (each row's X words contiguous; any row and
    batch stride, e.g. the [:, :, :X] view of [B, Ur, ncol*128] rows),
    row_idx [B, Y] int32, bcode [B, NB] u8, rloc [B, NB, 4] u8, mvk [B, K,
    2] int32, changed [B] bool → out [B, Y, X] (allocated unless given; it
    must not alias prev).

    CUDA kernel csrc/bc_compose.cu (its lane instance) for tensors on the
    card — one launch for all B streams; the plain twin only for tensors on
    the CPU."""
    if prev.device.type == "cpu":
        return cpu_result(lane_compose_ref(prev, rows, row_idx, bcode, rloc,
                                           mvk, changed), out)
    what = "lane_compose"
    if out is None:
        out = torch.empty_like(prev, memory_format=torch.contiguous_format)
    cuda_launch_checks(what, rows, row_idx)
    step_checks(what, prev, mvk, changed, out)
    block_code_checks(what, prev, bcode, rloc)
    B, Y, X = prev.shape
    K = mvk.shape[-2]
    Ur = rows.shape[1] if rows.dim() == 3 else -1
    if rows.shape != (B, Ur, X) or rows.stride(-1) != 1 or (
            Ur > 1 and rows.stride(-2) < X):
        raise ValueError(f"{what}: rows must be [{B}, Ur, {X}] with "
                         f"contiguous rows, got {tuple(rows.shape)} strides "
                         f"{rows.stride()}")
    if Ur == 0 and B and Y:
        raise IndexError(f"{what}: a row gather from zero rows (as "
                         f"jnp.take refuses)")
    if row_idx.shape != (B, Y) or row_idx.stride(-1) != 1:
        raise ValueError(f"{what}: row_idx must be [{B}, {Y}] with "
                         f"contiguous rows, got {tuple(row_idx.shape)}")
    if B and Y and X:
        lib = _build.load()
        with torch.cuda.device(prev.device):
            rc = lib.jsp_lane_compose(
                prev.data_ptr(), prev.stride(0), rows.data_ptr(),
                rows.stride(0), rows.stride(1), Ur, row_idx.data_ptr(),
                row_idx.stride(0), mvk.data_ptr(), mvk.stride(0),
                changed.data_ptr(), changed.stride(0), out.data_ptr(),
                out.stride(0), bcode.data_ptr(), bcode.stride(0),
                rloc.data_ptr(), rloc.stride(0), B, Y, X, K,
                torch.cuda.current_stream(prev.device).cuda_stream)
        _build.check(rc, what)
        lane_compose.launches += 1
    return out


lane_compose.launches = 0  # kernel launches (the plain path does not count)


def compose_frame_lane(prev, rows_unique, row_idx, btype, rect, mvk):
    """One frame, the reference's signature: prev [Y, X], rows_unique
    [Ur, X], row_idx [Y], btype [NB] u8, rect [NB, 4] u8, mvk [K, 2] →
    [Y, X]."""
    chg = torch.ones(1, dtype=torch.bool, device=prev.device)
    return lane_compose(prev[None], rows_unique[None], row_idx[None],
                        btype[None], rect[None], mvk[None], chg)[0]


# ---------------------------------------------------------------------------
# Windows
# ---------------------------------------------------------------------------

def scan_batch(init, rows, btype, rect, mvk, row_idx, changed):
    """The recon scan of B streams: init [B, Y, X], rows [B, Ur, X], btype
    [B, T, NB], rect [B, T, NB, 4], mvk [B, T, K, 2], row_idx [B, T, Y],
    changed [B, T] → frames [B, T, Y, X]; one lane_compose launch a step."""
    def step(prev, ri, bt, r, mk, chg, out):
        return lane_compose(prev, rows, ri, bt, r, mk, chg, out=out)

    return scan_steps(step, init, (row_idx, btype, rect, mvk), changed)


def _scan_frames(init, rows_unique, btype, rect, mvk, row_idx, changed):
    """The reference's one-stream scan: init [Y, X], rows_unique [Ur, X],
    btype [T, NB], … → frames [T, Y, X]."""
    return scan_batch(init[None], rows_unique[None], btype[None], rect[None],
                      mvk[None], row_idx[None], changed[None])[0]


def rows_batch(units: torch.Tensor, row_table: torch.Tensor,
               X: int) -> torch.Tensor:
    """units [B, U, 128] + row_table [B, Ur, ncol] → rows [B, Ur, X] (a
    view of [B, Ur, ncol*128])."""
    B, Ur, ncol = row_table.shape
    rows = torch.stack([take_rows(units[b], row_table[b].reshape(-1))
                        for b in range(B)]) if B else units.new_empty(
                            (0, Ur * ncol, 128))
    return rows.reshape(B, Ur, ncol * 128)[:, :, :X]


def decode_window_lane(init, refills, states, freq, btype, rect, mvk,
                       row_table, row_idx, changed, U: int):
    """One stream window, rans payload mode: init [Y, X]; refills [steps,
    N, 2] u8; states [N] (u32 bits); freq [256]; btype [T, NB]; rect
    [T, NB, 4]; mvk [T, K, 2]; row_table [Ur, ncol]; row_idx [T, Y];
    changed [T] → frames [T, Y, X]."""
    units = units_from_pack(refills, states, freq, U)
    rows_unique = rows_from_units(units, row_table, init.shape[1])
    return _scan_frames(init, rows_unique, btype, rect, mvk, row_idx, changed)


def decode_window_raw(init, payload, btype, rect, mvk, row_table, row_idx,
                      changed):
    """One stream window, raw payload mode (payload [U, 3, 128] u8; the
    rest as decode_window_lane)."""
    units = units_from_raw(payload)
    rows_unique = rows_from_units(units, row_table, init.shape[1])
    return _scan_frames(init, rows_unique, btype, rect, mvk, row_idx, changed)


def decode_batch_lane(init, refills, states, freq, btype, rect, mvk,
                      row_table, row_idx, changed, U: int):
    """Batched rans-mode decode, a leading [B] axis on every input (shared
    U/Ur buckets): one rans_decode_aligned launch for all B, then the scan
    with one lane_compose launch a step for all B."""
    B = btype.shape[0]
    syms = rans_lanes.rans_decode_aligned(refills, states, freq)
    units = units_from_raw(
        syms.reshape(B, -1)[:, : U * 384].reshape(B, U, 3, 128))
    rows = rows_batch(units, row_table, init.shape[-1])
    return scan_batch(init, rows, btype, rect, mvk, row_idx, changed)


def decode_batch_raw(init, payload, btype, rect, mvk, row_table, row_idx,
                     changed):
    """Batched raw-mode decode; payload [B, U, 3, 128] u8, the rest as
    decode_batch_lane."""
    rows = rows_batch(units_from_raw(payload), row_table, init.shape[-1])
    return scan_batch(init, rows, btype, rect, mvk, row_idx, changed)


def make_lane_decode_step(mesh, U: int, axes=("dp",), raw: bool = False):
    """The sharded lane decode over the mesh (pipeline/mesh.run_rows).
    `axes` names the mesh axes the leading batch axis shards over:
    ("dp",) = independent streams only; ("dp", "gop") additionally spreads
    restart windows (carry-independent, lane_format.LaneWindow.restart)
    of the same stream over the gop axis.  Entries are stream-major: index
    b * G + g for a group of G windows.  The step takes
    decode_batch_raw's inputs (raw) or decode_batch_lane's without U, each
    with the leading entry axis, and runs that decode on every slot's
    entries: one rans_decode_aligned launch (rans) and one lane_compose
    launch a scan step a slot.  No slot reads another's data."""
    from ..pipeline.mesh import run_rows

    decode = decode_batch_raw if raw else (
        lambda *args: decode_batch_lane(*args, U))
    return lambda *arrays: run_rows(mesh, decode, *arrays, axes=axes)

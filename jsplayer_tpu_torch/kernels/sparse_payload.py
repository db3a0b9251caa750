"""Sparse payload transport: data-rect tiles + a tile scatter on the card.

Counterpart of jsplayer_tpu/kernels/sparse_payload.py.  The dense command
layout ships a full [Y, X] u32 payload plane per frame even though only
data-block rects carry information.  This module packs only the painted
blocks:

  host:   payload [Y, X] + bts → tiles [M, 256] u32 (one 16×16 tile per
          active block, M padded to a bucket size) + tile_block [M] i32
  device: dense[NB, 256] = onehot(block→tile) @ tiles, then the usual
          reshape to [Y, X].

The reference runs the one-hot product on the TPU's matrix unit, which it
uses as a scatter engine.  The port's transport is a scatter, not a matrix
product: ``unpack_payload`` launches csrc/sparse_payload.cu (tensors on
the card), whose owner pass finds the tile of each block and whose dense
pass writes every word of [Y, X] once.  It gives the product's exact bits:
each word goes through f32 (u32 words at or above 2^24 round), tiles that
name one block are summed in f32, indices outside [0, NB) name no block,
and the f32 result converts back to u32 saturating (0xFFFFFFFF stays
0xFFFFFFFF).  ``unpack_payload_ref`` is the reference's formula in torch,
the plain twin for tensors on the CPU.

Per-frame traffic becomes ~activity-proportional: tiles (M·1KB) + indices,
e.g. 15% active blocks at 1080p ≈ 1.2 MB instead of 8.3 MB.

Status, as in the reference: the production sparse serving path is
kernels/sp_recon's kmv-sparse transport (ragged flat tiles, fed by the
native decoder — see pipeline/ingest).  This module is the scatter
alternative for payload-only workloads; no ingest route runs it.

``pack_tiles`` and ``pack_sequence`` are word-for-word copies of the
reference's numpy helpers (that module imports jax at the top, which the
port never does), including the reshape that raises on a frame whose
height or width 16 does not divide (a 1080-row frame: ROADMAP §3,
reference fault 9).  u32 words ride as int32 bits (device.py).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..device import cuda_launch_checks


def pack_tiles(payload: np.ndarray, bts: np.ndarray, m_max: int
               ) -> tuple[np.ndarray, np.ndarray]:
    """[Y,X] payload + [NB] bts → (tiles [m_max,256] u32, tile_block [m_max]
    i32, -1 padding).  Active = any block that paints payload pixels (bts 1,
    2, 4 — data variants; full-motion blocks need no payload)."""
    Y, X = payload.shape
    nbx = X // 16
    active = np.nonzero((bts > 0) & (bts != 3))[0]
    if len(active) > m_max:
        raise ValueError(f"m_max={m_max} < active blocks {len(active)}")
    tiles = np.zeros((m_max, 256), dtype=np.uint32)
    tile_block = np.full(m_max, -1, dtype=np.int32)
    p4 = payload.reshape(Y // 16, 16, nbx, 16).transpose(0, 2, 1, 3)
    for k, bi in enumerate(active):
        by, bx = divmod(int(bi), nbx)
        tiles[k] = p4[by, bx].reshape(256)
        tile_block[k] = bi
    return tiles, tile_block


def pack_sequence(payload: np.ndarray, bts: np.ndarray, m_max: int):
    """[T,Y,X], [T,NB] → stacked (tiles [T,m_max,256], tile_block [T,m_max])."""
    T = payload.shape[0]
    tiles = np.zeros((T, m_max, 256), dtype=np.uint32)
    blocks = np.full((T, m_max), -1, dtype=np.int32)
    for t in range(T):
        tiles[t], blocks[t] = pack_tiles(payload[t], bts[t], m_max)
    return tiles, blocks


def _frame_checks(what: str, nb: int, Y: int, X: int) -> None:
    """The reference's reshape of [NB, 256] into [Y, X]: whole 16x16 blocks
    and NB = (Y/16)(X/16)."""
    if Y % 16 or X % 16 or nb != (Y // 16) * (X // 16):
        raise ValueError(f"{what}: nb={nb} tiles of 16x16 do not make a "
                         f"{Y}x{X} frame")


def _to_plane(dense: torch.Tensor, Y: int, X: int) -> torch.Tensor:
    """[..., NB, 256] block-ordered words → [..., Y, X]."""
    lead = tuple(dense.shape[:-2])
    nbx = X // 16
    return (dense.reshape(lead + (Y // 16, nbx, 16, 16))
            .transpose(-3, -2).reshape(lead + (Y, X)))


def unpack_payload_ref(tiles: torch.Tensor, tile_block: torch.Tensor,
                       nb: int, Y: int, X: int) -> torch.Tensor:
    """Plain twin, the reference's formula: tiles [M, 256] int32 bits,
    tile_block [M] → [Y, X] int32 bits.  onehot[NB, M] (f32) @ tiles as u32
    values in f32, the f32 sums taken to u32 saturating (clamped to
    [0, 2^32 - 1], as XLA converts), then block order to plane order.  On
    the card it needs full f32 products
    (torch.backends.cuda.matmul.allow_tf32 False, torch's default)."""
    _frame_checks("unpack_payload_ref", nb, Y, X)
    dev = tiles.device
    onehot = (tile_block[None, :].to(torch.int64)
              == torch.arange(nb, device=dev)[:, None]).to(torch.float32)
    words = (tiles.to(torch.int64) & 0xFFFFFFFF).to(torch.float32)
    dense = onehot @ words  # [NB, 256]
    dense = dense.to(torch.int64).clamp_(0, 0xFFFFFFFF)
    dense = torch.where(dense > 0x7FFFFFFF, dense - (1 << 32), dense)
    return _to_plane(dense.to(torch.int32), Y, X)


def unpack_payload(tiles: torch.Tensor, tile_block: torch.Tensor, nb: int,
                   Y: int, X: int) -> torch.Tensor:
    """Device reconstruct: tiles [M, 256] int32 bits, tile_block [M] int32
    → dense payload [Y, X] int32 bits (zeros outside data blocks); with a
    leading T axis (tiles [T, M, 256], tile_block [T, M]) → [T, Y, X], one
    launch for the window.

    CUDA kernel csrc/sparse_payload.cu for tensors on the card; the plain
    twin (frame by frame) only for tensors on the CPU.  tiles may be a
    strided view whose 256-word rows are contiguous; tile_block needs
    contiguous rows."""
    what = "unpack_payload"
    _frame_checks(what, nb, Y, X)
    single = tiles.dim() == 2
    if single:
        tiles, tile_block = tiles[None], tile_block[None]
    if tiles.device.type == "cpu":
        out = torch.stack([unpack_payload_ref(tiles[t], tile_block[t], nb,
                                              Y, X)
                           for t in range(tiles.shape[0])]) \
            if tiles.shape[0] else torch.empty((0, Y, X), dtype=torch.int32)
        return out[0] if single else out
    cuda_launch_checks(what, tiles, tile_block)
    # an empty window has no rows to lay out
    if tiles.dim() != 3 or tiles.shape[-1] != 256 or (
            tiles.numel() and tiles.stride(-1) != 1):
        raise ValueError(f"{what}: tiles must be [T, M, 256] with "
                         f"contiguous rows, got {tuple(tiles.shape)} "
                         f"strides {tiles.stride()}")
    T, M = tiles.shape[:2]
    if tuple(tile_block.shape) != (T, M) or (M and tile_block.stride(-1)
                                             != 1):
        raise ValueError(f"{what}: tile_block must be [{T}, {M}] with "
                         f"contiguous rows, got {tuple(tile_block.shape)}")
    out = torch.empty((T, Y, X), dtype=torch.int32, device=tiles.device)
    if T and nb:
        # the owner of each block of each frame: -1 none, -2 several
        owner = torch.empty((T, nb), dtype=torch.int32, device=tiles.device)
        lib = _build.load()
        with torch.cuda.device(tiles.device):
            rc = lib.jsp_unpack_payload(
                tiles.data_ptr(), tiles.stride(0), tiles.stride(1),
                tile_block.data_ptr(), tile_block.stride(0),
                owner.data_ptr(), out.data_ptr(), T, M, nb, Y, X,
                torch.cuda.current_stream(tiles.device).cuda_stream)
        _build.check(rc, what)
        unpack_payload.launches += 1
    return out[0] if single else out


unpack_payload.launches = 0  # kernel launches (the plain path does not count)


def decode_sequence_sparse(init_frame, bts, mv, rect, tiles, tile_block,
                           changed, insignificant_blocks):
    """sp_recon.decode_sequence with sparse payload transport: init [Y, X],
    bts [T, NB], mv [T, NB, 2], rect [T, NB, 4], tiles [T, M, 256],
    tile_block [T, M], changed [T] → (frames [T, Y, X], signif [T]).  One
    unpack_payload launch for the window, then the general compose's scan
    (one sp_compose_general launch a step): frame t is
    compose_frame(frame t-1, commands t, payload t) where changed[t], a
    copy of frame t-1 elsewhere; signif[t] is changed[t] and some block at
    or past insignificant_blocks has bts > 0."""
    from .sp_recon import decode_sequence

    Y, X = init_frame.shape
    payload = unpack_payload(tiles, tile_block, bts.shape[1], Y, X)
    return decode_sequence(init_frame, bts, mv, rect, payload, changed,
                           insignificant_blocks)

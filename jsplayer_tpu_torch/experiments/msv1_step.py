"""MSVideo1 streams and windows for csrc/msv1_paint.cu at its users' sizes.

  * ``msv1_streams(bits, B, T, X, Y)``: B MSV1 AVIs of T frames made by the
    port's encode/msv1_enc.py: screen-like content (a flat desktop, windows
    of two colours a 2x2 quadrant opening, moving and repainting, a third of
    the frames stills), 16-bit or 8-bit palettized (with two MP3 sound
    chunks, BASELINE config 2's shape; the batch shares one palette, as the
    ingest decodes every stream with the first one's).  MSV1 encoding is
    numpy work block by block, slow at CIF, so the batch draws on a pool:
    ``POOL`` distinct streams (stream b is pool stream b % POOL), each a
    period of ``PERIOD`` frames led by a keyframe, repeated;
  * ``window_inputs(device)``: a random B=8 CIF window of commands;
  * ``msv1_bytes``: the bytes a window must move on its data, and
    ``msv1_sector_bytes``: the bytes a kernel that reads only what it needs
    moves at DRAM's 32-byte sector grain.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .common import io_bytes

PERIOD = 16
POOL = 4


def _frames(rng, bits, T, X, Y):
    """T source frames [Y, X] of one stream: u32 RGB555-lattice words
    (16-bit) or palette indices (8-bit)."""
    from ..codecs.msvideo1 import from_rgb15

    qy, qx = np.mgrid[0:Y, 0:X] // 2
    ncol = 12
    if bits == 16:
        pal = np.array([from_rgb15(int(c)) for c in
                        rng.integers(0, 0x8000, ncol)], dtype=np.uint32)
    else:
        pal = rng.choice(256, ncol, replace=False).astype(np.uint8)
    f = np.full((Y, X), pal[0], dtype=pal.dtype)
    out = []
    for t in range(T):
        f = f.copy()
        if t % 3 != 2:  # a window opens or repaints: 2 colours a quadrant
            h, w = (int(rng.integers(2, max(3, Y // 16))) * 4,
                    int(rng.integers(2, max(3, X // 16))) * 4)
            y0 = int(rng.integers(0, (Y - h) // 4 + 1)) * 4
            x0 = int(rng.integers(0, (X - w) // 4 + 1)) * 4
            pair = rng.integers(0, ncol, (Y // 2, X // 2, 2))
            img = pal[pair[qy, qx, rng.integers(0, 2, (Y, X))]]
            f[y0:y0 + h, x0:x0 + w] = img[y0:y0 + h, x0:x0 + w]
        out.append(f)
    return out, pal


def _stream(args):
    """One stream: PERIOD encoded frames, repeated to T → (chunks, the
    PERIOD source frames as decoded u32 pixels [Y*X], palette bytes or
    None)."""
    from ..encode.msv1_enc import encode_frame_8, encode_frame_16

    seed, batch_seed, bits, T, X, Y = args
    rng = np.random.default_rng(seed)
    frames, pal = _frames(rng, bits, PERIOD, X, Y)
    enc = encode_frame_16 if bits == 16 else encode_frame_8
    chunks, prev = [], None
    for f in frames:
        flat = f.reshape(-1)
        chunks.append(enc(flat, prev, X, Y))
        prev = flat
    pal_bytes, pixels = None, [f.reshape(-1) for f in frames]
    if bits == 8:  # the AVI's palette: 256 24-bit colours, one a batch
        from ..codecs.msvideo1 import palette_to_u32

        pal_bytes = np.random.default_rng(batch_seed).integers(
            0, 1 << 24, 256).astype("<u4").tobytes()
        pixels = [palette_to_u32(pal_bytes)[p] for p in pixels]
    reps = -(-T // PERIOD)
    return (chunks * reps)[:T], pixels, pal_bytes


def msv1_streams(bits: int, B: int, T: int, X: int, Y: int,
                 seed: int = 0) -> dict:
    """B streams → {"avis", "chunks", "frames": [B] of [PERIOD] source
    frames (decoded u32 pixels [Y*X]), "palettes", "period", "pool"}; frame
    t of stream b is frames[b][t % PERIOD]."""
    from ..encode.avi_mux import mux_avi

    with ThreadPoolExecutor(min(B, POOL)) as ex:
        pool = list(ex.map(_stream, [(seed + b, seed, bits, T, X, Y)
                                     for b in range(min(B, POOL))]))
    got = [pool[b % POOL] for b in range(B)]
    avis = []
    for chunks, _, pal in got:
        kw = dict(keyflags=[t % PERIOD == 0 for t in range(T)])
        if bits == 8:
            from ..encode.mp3_synth import make_frames

            mp3, _, _ = make_frames(40)
            kw.update(palette=pal, sound_chunks=[(1, mp3[: len(mp3) // 2]),
                                                 (4, mp3[len(mp3) // 2:])])
        avis.append(mux_avi(chunks, X, Y, bits, codec="CRAM", **kw))
    return {"avis": avis, "chunks": [g[0] for g in got],
            "frames": [g[1] for g in got], "palettes": [g[2] for g in got],
            "period": PERIOD, "pool": min(B, POOL)}


def window_inputs(device, B: int = 8, T: int = 64, Y: int = 288,
                  X: int = 352, seed: int = 11) -> tuple:
    """A random CIF window → (init [B, Y, X], btype [B, T, NB] (a tenth of
    the blocks painted, btype 1-2), sel [B, T, Y, X] (0-8: one in nine
    keeps the pixel), colors [B, T, NB, 8]) on `device`."""
    rng = np.random.default_rng(seed)
    nb = (Y // 4) * (X // 4)
    init = rng.integers(0, 1 << 32, (B, Y, X), dtype=np.uint32)
    bt = ((rng.random((B, T, nb)) < 0.1)
          * rng.integers(1, 3, (B, T, nb))).astype(np.uint8)
    sel = rng.integers(0, 9, (B, T, Y, X)).astype(np.uint8)
    col = rng.integers(0, 1 << 32, (B, T, nb, 8), dtype=np.uint32)
    return tuple(torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                                  else a).to(device)
                 for a in (init, bt, sel, col))


def msv1_bytes(init, btype, frames) -> int:
    """Bytes one msv1_paint window must move on its data: init read once,
    every frame written, btype read, and sel (16 bytes) and the colours (32
    bytes) of each painted block, and the [B, T] diff flags."""
    painted = int((btype > 0).sum())
    return (io_bytes(init, btype, frames) + 48 * painted
            + 4 * btype.shape[0] * btype.shape[1])


def msv1_sector_bytes(init, btype, frames) -> int:
    """Bytes a window moves where every read is a whole 32-byte sector (the
    DRAM grain): msv1_bytes with the sel rows of painted blocks counted as
    the sectors they lie in (8 blocks' rows a sector) and btype as whole
    sectors of each step's row; init, frames and colours are whole sectors
    already."""
    B, T, nb = btype.shape
    Y, X = init.shape[-2:]
    nbx = X // 4
    painted = (btype > 0).reshape(B, T, Y // 4, nbx)
    groups = torch.nn.functional.pad(painted.to(torch.int8), (0, -nbx % 8))
    sectors = int(groups.reshape(B, T, Y // 4, -1, 8).any(-1).sum())
    bt_sectors = B * T * -(-nb // 32)
    return (io_bytes(init, frames) + 32 * bt_sectors + 4 * 32 * sectors
            + 32 * int(painted.sum()) + 4 * B * T)


def main() -> int:
    """Time msv1_paint on the random B=8 CIF window (CUDA events through the
    wrapper, and as a CUDA graph), held against its twin → one JSON line:
    the times, the instance that ran, the bytes the window must move
    (msv1_bytes: the bound) and at the sector grain."""
    import json

    from ..kernels.msv1_paint import msv1_paint, msv1_paint_ref
    from .common import HBM_BYTES_PER_MS, card, graph_ms, time_ms

    dev, name = card()
    init, bt, sel, col = window_inputs(dev)
    frames, diff = msv1_paint(init, bt, sel, col, 0)
    want = msv1_paint_ref(init, bt, sel, col, 0)
    exact = bool(torch.equal(frames, want[0]) and torch.equal(diff, want[1]))

    def call():
        msv1_paint(init, bt, sel, col, 0, out=frames)

    nbytes = msv1_bytes(init, bt, frames)
    res = dict(card=name, shape=list(frames.shape), exact=exact,
               instance=getattr(msv1_paint, "last_instance", None),
               ms=time_ms(call), graph_ms=graph_ms(call), bytes=nbytes,
               sector_bytes=msv1_sector_bytes(init, bt, frames),
               bound_ms=nbytes / HBM_BYTES_PER_MS)
    res["share"] = res["bound_ms"] / res["graph_ms"]
    print(json.dumps(res), flush=True)
    return 0 if exact else 1


if __name__ == "__main__":
    raise SystemExit(main())

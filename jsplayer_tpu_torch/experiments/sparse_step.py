"""Inputs and byte counts of csrc/kmv_sparse.cu's step at 1080p, B=4.

  * ``step_inputs(device)``: a random step in the host's layout (tiles at
    clamped 16-grid starts in raster order, 1080 % 16 = 8 so the bottom
    row's tiles overlap the row above, pads at (0, 0)), with wrapping
    vectors and -2^31, codes past 2+K, tile indices that wrap or fall
    outside the rows, and one unchanged stream;
  * ``captured_step(chunks, src, device)``: the step with the most tiles of
    the port's native sparse emission of the streams (each stream decoded
    frame by frame, as the ingest's native branch does), ragged as the
    ingest ships it, with prev the source frames before it;
  * ``sparse_bytes``: the bytes a step must move on its data;
  * ``node_split``: the device time of each node a call enqueues (a fill of
    the cell scratch where there is one, the owner pass, the compose),
    traced.
"""

from __future__ import annotations

import numpy as np
import torch

from .block_step import B, X, Y
from .common import io_bytes

K = 2
NBY, NBX = (Y + 15) // 16, (X + 15) // 16
NB = NBY * NBX


def _dev(a: np.ndarray, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                            else a).to(device)


def ragged(tiles_rows, bcode, mvk, starts, device) -> tuple:
    """Per stream: tiles_rows[b], its m_b tiles' rows [*, 256] u32 and then
    the pad row (block (0, 0)'s content; none where m_b = NB), and starts[b]
    [m_b, 2] → the ingest's ragged step: (bcode, mvk, tiles [S, 256],
    tile_idx [B, m_pad] (slots past m_b read the pad row, at (0, 0)),
    tile_yx [B, m_pad, 2]), m_pad the power of two at or above the most
    tiles, on `device`."""
    m_max = max(1, max(len(st) for st in starts))
    m_pad = min(1 << (m_max - 1).bit_length(), NB)
    off = 0
    idx = np.zeros((len(tiles_rows), m_pad), np.int32)
    yx = np.zeros((len(tiles_rows), m_pad, 2), np.int32)
    for b, (rows, st) in enumerate(zip(tiles_rows, starts)):
        idx[b] = off + np.minimum(np.arange(m_pad), len(rows) - 1)
        yx[b, : len(st)] = st
        off += len(rows)
    return (_dev(bcode, device), _dev(mvk, device),
            _dev(np.concatenate(tiles_rows), device), _dev(idx, device),
            _dev(yx, device))


def step_inputs(device, seed: int = 9) -> tuple:
    """A random B=4 1080p step → (prev, [bcode, mvk, tiles, tile_idx,
    tile_yx], changed) on `device`: a 20th to a 7th of the blocks are tiles
    in each stream (408-1165 at 1080p), stream 2 unchanged, a twentieth of
    the indices wrapping or outside the rows."""
    rng = np.random.default_rng(seed)
    prev = rng.integers(0, 1 << 32, (B, Y, X), dtype=np.uint32)
    bcode = rng.integers(0, K + 4, (B, NB)).astype(np.uint8)
    mvk = np.stack([rng.integers(-3 * X, 3 * X, (B, K)),
                    rng.integers(-3 * Y, 3 * Y, (B, K))], -1)
    mvk[0, 0] = (-(2**31), 7)
    rows, starts = [], []
    for b in range(B):
        n = int(rng.integers(max(1, NB // 20), max(2, NB // 7)))
        blocks = np.sort(rng.choice(NB, n, replace=False))
        by, bx = np.divmod(blocks, NBX)
        starts.append(np.stack([np.minimum(by * 16, Y - 16),
                                np.minimum(bx * 16, X - 16)], -1))
        rows.append(rng.integers(0, 1 << 32, (len(blocks) + 1, 256),
                                 dtype=np.uint32))
    bcode_d, mvk_d, tiles, idx, yx = ragged(rows, bcode,
                                            mvk.astype(np.int32), starts,
                                            device)
    S = tiles.shape[0]
    wild = torch.from_numpy(rng.random(tuple(idx.shape)) < 0.05).to(device)
    idx = torch.where(wild, idx - S - 2 * (idx % 2), idx)
    chg = torch.tensor([True, True, False, True], device=device)
    return _dev(prev, device), [bcode_d, mvk_d, tiles, idx, yx], chg


def captured_step(chunks, src, device) -> tuple:
    """The P-frame step t > 0 with the most tiles over the streams, among
    those where every stream changed and none is a keyframe, of the port's
    native sparse emission → (t, prev [B, Y, X] = the source frames t-1,
    [bcode, mvk, tiles, tile_idx, tile_yx], changed, want = the source
    frames t), on `device`."""
    from concurrent.futures import ThreadPoolExecutor

    from .. import native

    T = len(chunks[0])

    def stream(b):
        d = native.NativeScreenPressor(X, Y, 24)
        d.preinit(0)
        bc, mk = np.zeros(NB, np.uint8), np.zeros((K, 2), np.int32)
        tiles, yx = np.zeros((NB, 16, 16), np.uint32), np.zeros((NB, 2),
                                                                np.int32)
        out = []
        for src_t in chunks[b]:
            key = d.is_key_frame(src_t)
            chg, _, m = d.decompress_kmv_sparse(src_t, key, bc, mk, tiles,
                                                yx, K=K)
            take = min(m + 1, NB)  # the native pad row after the tiles
            out.append(None if key or not chg else (
                bc.copy(), mk.copy(),
                tiles[:take].reshape(take, 256).copy(), yx[:m].copy()))
        return out

    with ThreadPoolExecutor(len(chunks)) as ex:
        got = list(ex.map(stream, range(len(chunks))))
    best, t_best = -1, None
    for t in range(1, T):
        if all(g[t] is not None for g in got):
            n = sum(len(g[t][3]) for g in got)
            if n > best:
                best, t_best = n, t
    if t_best is None:
        raise RuntimeError("no step where every stream changed")
    step = [g[t_best] for g in got]
    args = ragged([s[2] for s in step], np.stack([s[0] for s in step]),
                  np.stack([s[1] for s in step]), [s[3] for s in step],
                  device)
    prev = torch.stack([s[t_best - 1] for s in src]).to(device)
    want = torch.stack([s[t_best] for s in src]).to(device)
    chg = torch.ones(len(chunks), dtype=torch.bool, device=device)
    return t_best, prev, list(args), chg, want


def sparse_bytes(prev, args, chg) -> int:
    """Bytes one kmv_sparse_compose step must move on its data: out written
    and one source word read a pixel (its owning tile's, a moved prev, or
    prev; an unchanged stream reads prev), plus each changed stream's
    bcode, mvk, tile_idx and tile_yx, and changed."""
    bcode, mvk, _, idx, yx = args
    cmds = sum(io_bytes(bcode[b], mvk[b], idx[b], yx[b])
               for b in range(prev.shape[0]) if bool(chg[b]))
    return 8 * prev.numel() + cmds + io_bytes(chg)


def node_split(step, calls: int = 50) -> dict:
    """us a call of each node that step() enqueues, by torch.profiler over
    `calls` calls after a warm-up one → {"fill", "owner", "compose",
    "other"} (0.0 for a node the call does not have).  A node's time runs
    from its start to its end on the card: a compose that starts early, as
    the owner pass's programmatic dependent, counts its wait too."""
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            step()
        torch.cuda.synchronize()
    split = dict(fill=0.0, owner=0.0, compose=0.0, other=0.0)
    for ev in prof.key_averages():
        name = ev.key
        if name.startswith("cuda"):  # runtime calls, not device work
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        low = name.lower()
        kind = ("owner" if "sparse_owner" in low else
                "compose" if "kmv_sparse_kernel" in low else
                "fill" if "memset" in low else "other")
        split[kind] += us / calls
    return split


def main() -> int:
    """Time kmv_sparse_compose on the random step and on the captured step
    of block_step's streams (CUDA events through the wrapper, and as a CUDA
    graph, and each node traced), each held against its twin → one JSON
    line."""
    import json

    from ..kernels.sp_recon import kmv_sparse_compose, kmv_sparse_compose_ref
    from .block_step import screen_streams
    from .common import HBM_BYTES_PER_MS, card, graph_ms, time_ms

    dev, name = card()
    _, frames, chunks = screen_streams()
    src = [torch.from_numpy(f.view(np.int32)) for f in frames]
    cap = captured_step(chunks, src, dev)
    res = {"card": name}
    for what, (prev, args, chg) in (("random", step_inputs(dev)),
                                    ("captured", cap[1:4])):
        want = kmv_sparse_compose_ref(prev, *args, chg)
        out = kmv_sparse_compose(prev, *args, chg)
        exact = bool(torch.equal(out, want))

        def step():
            kmv_sparse_compose(prev, *args, chg, out=out)

        nbytes = sparse_bytes(prev, args, chg)
        res[what] = dict(ms=time_ms(step), graph_ms=graph_ms(step),
                         bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_MS,
                         M=int(args[3].shape[1]), S=int(args[2].shape[0]),
                         nodes_us=node_split(step))
        res[what]["share"] = res[what]["bound_ms"] / res[what]["graph_ms"]
        # again after every timed call: each left the cell scratch clean
        out.fill_(0)
        res[what]["exact"] = exact and bool(torch.equal(
            kmv_sparse_compose(prev, *args, chg, out=out), want))
    print(json.dumps(res), flush=True)
    return 0 if res["random"]["exact"] and res["captured"]["exact"] else 1


if __name__ == "__main__":
    raise SystemExit(main())

"""The three modes of csrc/sp_motion.cu at two B=4 1080p steps: their
times as CUDA events around wrapper calls and as a CUDA graph, beside the
bytes each step must move.

    python -m jsplayer_tpu_torch.experiments.block_step

prints one JSON line: {"card": "<name>, <power limit>", "<kernel>": {"ms":
..., "graph_ms": ..., "bytes": ..., "bound_ms": ..., "exact": ...}, ...,
"captured": {"step": t, "<kernel>": {...}, ...}} for sp_compose_general,
sp_motion_patch and sp_motion_mxu; `exact` holds the result against the
plain twin (and, on the captured step, the source frames), bit for bit.

The top-level step is made with numpy from one seed: bts -1..7 with rects
that split 4-pixel vectors, motion vectors with mx % 4 == 0 and != 0 whose
sources lie in the frame or leave it at every edge, and stream 2
unchanged.  The captured step is chip_smoke.py's: the native decoder's
capture of four 128-frame streams of the bench screen mix, at the step
with the most full-block motion.  The script calls only the public
signatures of the three wrappers, so copied with experiments/common.py
into an earlier checkout of the port, it times that checkout's kernels on
the same inputs in the same way.
"""

from __future__ import annotations

import json
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .common import HBM_BYTES_PER_MS, block_bytes, card, graph_ms, time_ms

B, T, Y, X = 4, 128, 1080, 1920
CHANGED = [True, True, False, True]
KEYFRAMES = (0, 40)  # the captured streams' keyframes


def step_commands(seed: int = 0):
    """numpy commands of one B-stream step → (prev, bts [B, NB], mv
    [B, NB, 2], rect [B, NB, 4], payload) int32, frames [B, Y, X]."""
    rng = np.random.default_rng(seed)
    nby, nbx = (Y + 15) // 16, (X + 15) // 16
    nb = nby * nbx
    by, bx = (np.arange(nb) // nbx) * 16, (np.arange(nb) % nbx) * 16
    bts = rng.integers(-1, 8, (B, nb))
    # sources inside the frame, half of them with mx % 4 == 0
    sy = rng.integers(0, Y - 15, (B, nb))
    sx = rng.integers(0, X - 15, (B, nb))
    sx = np.where(rng.random((B, nb)) < 0.5, sx & ~3, sx)
    mv = np.stack([sx - bx, sy - by], -1)
    # half of the edge blocks move from up to 20 pixels outside their edge
    out = rng.random((B, nb)) < 0.5
    step = rng.integers(1, 21, (B, nb))
    for edge, axis, sign in ((by == 0, 1, -1), (by == (nby - 1) * 16, 1, 1),
                             (bx == 0, 0, -1), (bx == (nbx - 1) * 16, 0, 1)):
        mv[..., axis] = np.where(out & edge, sign * step, mv[..., axis])
    x0 = bx + rng.integers(-2, 10, (B, nb))
    y0 = by + rng.integers(-2, 10, (B, nb))
    rect = np.stack([x0, y0, x0 + rng.integers(0, 12, (B, nb)),
                     y0 + rng.integers(0, 12, (B, nb))], -1)
    prev, payload = (rng.integers(0, 1 << 32, (B, Y, X), dtype=np.uint32)
                     .view(np.int32) for _ in range(2))
    return prev, bts.astype(np.int32), mv.astype(np.int32), \
        rect.astype(np.int32), payload


def screen_stream(seed: int):
    """One SP v4 1080p stream of T frames of the bench screen mix (scroll
    + paint events, a third stills) with keyframes at KEYFRAMES → (AVI
    bytes, source frames [T, Y, X] u32, the frames' chunks)."""
    from .. import native
    from ..encode.avi_mux import mux_avi
    from ..utils.corpora import screen_mix

    frames = np.stack(screen_mix(T=T, Y=Y, X=X, seed=seed))
    enc = native.NativeScreenPressorEncoder(4, X, Y)
    chunks = [enc.encode_i(f.reshape(-1)) if t in KEYFRAMES
              else enc.encode_p(f.reshape(-1)) for t, f in enumerate(frames)]
    keys = [t in KEYFRAMES for t in range(T)]
    return (mux_avi(chunks, X, Y, 24, codec="SPV4", keyflags=keys), frames,
            chunks)


def screen_streams():
    """screen_stream(0) .. screen_stream(B-1), encoded in parallel → (AVI
    bytes, source frames, chunks), each a list over the streams."""
    with ThreadPoolExecutor(B) as ex:
        got = list(ex.map(screen_stream, range(B)))
    return tuple([g[i] for g in got] for i in range(3))


def motion_step(bts: torch.Tensor, changed: torch.Tensor) -> int:
    """The scan step t > 0 with the most full-block motion over all
    streams among those where every stream changed (bts [B, T, NB],
    changed [B, T])."""
    ok = changed.all(dim=0)
    ok[0] = False
    return int(torch.where(ok, (bts == 3).sum(dim=(0, 2)), -1).argmax())


def mode_inputs(prev, cmds, chg) -> dict:
    """{kernel: (wrapper, plain twin, args)} of a step's commands [bts,
    mv, rect, payload] (mxu: mxu_commands of them)."""
    from ..kernels import sp_motion_mxu as PM
    from ..kernels import sp_motion_pallas as PP
    from ..kernels import sp_recon as P

    mxu = [torch.stack(c) for c in zip(*(
        PM.mxu_commands(*(c[b] for c in cmds)) for b in range(len(chg))))]
    return {"sp_compose_general": (P.sp_compose_general,
                                   P.compose_frame_ref, cmds),
            "sp_motion_patch": (PP.sp_motion_patch,
                                PP.compose_frame_fast_ref, cmds),
            "sp_motion_mxu": (PM.sp_motion_mxu, PM.compose_frame_mxu_ref,
                              mxu)}


def time_step(prev, cmds, chg, want=None) -> dict:
    """{kernel: {"ms": CUDA events around 20 wrapper calls, "graph_ms": 20
    calls replayed as a CUDA graph, "bytes", "bound_ms", "exact"}} of one
    step; `want`, where given, is what every mode must compose."""
    from ..kernels.sp_recon import per_stream_ref

    res = {}
    for name, (step, ref, args) in mode_inputs(prev, cmds, chg).items():
        out = torch.empty_like(prev)

        def call():
            step(prev, *args, chg, out=out)

        call()
        exact = torch.equal(out, per_stream_ref(ref, prev, chg, *args)) and (
            want is None or torch.equal(out, want))
        nbytes = block_bytes(name, prev, args, chg)
        res[name] = dict(ms=time_ms(call), graph_ms=graph_ms(call),
                         bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_MS,
                         exact=exact)
    return res


def captured_step(device):
    """chip_smoke.py's captured step → (t, prev [B, Y, X] (the source
    frames t-1), [bts, mv, rect, payload] at t, changed, the source frames
    at t), on `device`."""
    from .. import native

    _, frames, chunks = screen_streams()
    cap = native.native_sp_decode_streams(chunks, X, Y)

    def dev(a, to=device):
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)) \
            .to(to)

    t = motion_step(dev(cap["bts"], "cpu"),
                    torch.from_numpy(cap["changed"].astype(bool)))
    cmds = [dev(cap[k][:, t]) for k in ("bts", "mv", "rect", "payload")]
    prev = dev(np.stack([f[t - 1] for f in frames]))
    return (t, prev, cmds, torch.ones(B, dtype=torch.bool, device=device),
            dev(np.stack([f[t] for f in frames])))


def main() -> None:
    device, line = card()
    prev, *cmds = (torch.from_numpy(a).to(device) for a in step_commands())
    res = time_step(prev, cmds, torch.tensor(CHANGED, device=device))
    t, prev, cmds, chg, want = captured_step(device)
    res["captured"] = dict(step=t, **time_step(prev, cmds, chg, want))
    print(json.dumps(dict(card=line, **res)), flush=True)


if __name__ == "__main__":
    main()

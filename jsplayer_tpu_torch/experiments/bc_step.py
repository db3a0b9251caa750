"""bc_compose (csrc/bc_compose.cu) at two B=4 1080p steps: its times as
CUDA events around wrapper calls and as a CUDA graph, beside the bytes each
step must move.

    python -m jsplayer_tpu_torch.experiments.bc_step

prints one JSON line: {"card": "<name>, <power limit>", "random": {"ms":
..., "graph_ms": ..., "bytes": ..., "bound_ms": ..., "exact": ...},
"captured": {"step": t, ...}}.  `exact` holds the result against the plain
twin (and, on the captured step, the source frames), bit for bit.

The random step is made with numpy from one seed (step_inputs): codes
0..5 (motion slots 0 and 1, and codes past them) and 255, rects with
bounds 0..20 and a third of whole blocks, wrapping vectors, stream 2
unchanged, a plane of random words everywhere.  The captured step is
chip_smoke.py's: the native decoder's bc transport of four 128-frame
streams of the bench screen mix, at the step with the most motion blocks.
The script calls only bc_compose's public signature, so copied with
experiments/common.py and block_step.py into another checkout of the port,
it times that checkout's kernel on the same inputs in the same way.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from .block_step import B, X, Y, screen_streams
from .common import HBM_BYTES_PER_MS, bc_bytes, card, graph_ms, time_ms

#: a B=4 row of K=2 (mx, my) a stream: small and negative; out of frame
#: and near -2^31; stream 2 unchanged; |mv| >= Y, X and -2^31 itself
MVK = [[[3, -5], [-8, 2]], [[-2000, 1500], [-(2**31) + 5, -1085]],
       [[16, 16], [-16, 0]], [[0, Y], [-(2**31), -2 * Y - 1]]]
CHANGED = [True, True, False, True]


def step_inputs(device, seed: int = 0):
    """The random B=4 1080p step → (prev, [plane, bcode, rloc, mvk],
    changed) on `device`."""
    rng = np.random.default_rng(seed)
    nb = ((Y + 15) // 16) * ((X + 15) // 16)
    bcode = rng.integers(0, 6, (B, nb))
    bcode = np.where(rng.random((B, nb)) < 0.05, 255, bcode)
    lo, hi = rng.integers(0, 19, (B, nb, 2)), rng.integers(0, 21, (B, nb, 2))
    rloc = np.stack([lo[..., 0], lo[..., 1], hi[..., 0], hi[..., 1]], -1)
    rloc[rng.random((B, nb)) < 1 / 3] = (0, 0, 16, 16)
    prev, plane = (rng.integers(0, 1 << 32, (B, Y, X), dtype=np.uint32)
                   .view(np.int32) for _ in range(2))
    dev = [torch.from_numpy(a).to(device) for a in (
        prev, plane, bcode.astype(np.uint8), rloc.astype(np.uint8),
        np.array(MVK, dtype=np.int32))]
    return dev[0], dev[1:], torch.tensor(CHANGED, device=device)


def transport_args(bc: dict, b, t, device) -> list:
    """[plane, bcode, rloc, mvk] of a native bc transport's arrays at
    [b, t] (indices or slices) on `device`."""
    return [torch.from_numpy(np.ascontiguousarray(bc[k][b, t]).view(
        np.int32) if k == "plane" else np.ascontiguousarray(bc[k][b, t]))
            .to(device) for k in ("plane", "bcode", "rloc", "mvk")]


def motion_step(bc: dict) -> int:
    """The step t > 0 with the most motion blocks (code >= 2) over all
    streams among those where every stream changed."""
    ok = bc["changed"].all(axis=0)
    ok[0] = False
    return int(np.where(ok, (bc["bcode"] >= 2).sum(axis=(0, 2)), -1).argmax())


def time_step(prev, args, chg, want=None) -> dict:
    """{"ms": CUDA events around 20 wrapper calls, "graph_ms": 20 calls
    replayed as a CUDA graph, "bytes", "bound_ms", "exact"} of one step;
    `want`, where given, is what it must compose."""
    from ..kernels.sp_recon import bc_compose, bc_compose_ref

    out = torch.empty_like(prev)

    def call():
        bc_compose(prev, *args, chg, out=out)

    call()
    exact = torch.equal(out, bc_compose_ref(prev, *args, chg)) and (
        want is None or torch.equal(out, want))
    nbytes = bc_bytes(prev, args, chg)
    return dict(ms=time_ms(call), graph_ms=graph_ms(call), bytes=nbytes,
                bound_ms=nbytes / HBM_BYTES_PER_MS, exact=exact)


def main() -> None:
    from .. import native

    device, line = card()
    res = {"random": time_step(*step_inputs(device))}
    _, frames, chunks = screen_streams()
    bc = native.native_sp_decode_streams_bc(chunks, X, Y, K=2)
    t = motion_step(bc)
    prev = torch.from_numpy(np.stack([f[t - 1] for f in frames])
                            .view(np.int32)).to(device)
    want = torch.from_numpy(np.stack([f[t] for f in frames])
                            .view(np.int32)).to(device)
    res["captured"] = dict(step=t, **time_step(
        prev, transport_args(bc, slice(None), t, device),
        torch.ones(B, dtype=torch.bool, device=device), want))
    print(json.dumps(dict(card=line, **res)), flush=True)


if __name__ == "__main__":
    main()

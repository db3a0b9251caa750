"""The two kmv kernels at a B=4 1080p random step: their inputs, and their
times as CUDA events around wrapper calls and as a CUDA graph.

    python -m jsplayer_tpu_torch.experiments.kmv_step

prints one JSON line: {"card": "<name>, <power limit>", "kmv_compose":
{"ms": ..., "graph_ms": ...}, "kmv_compose_ds2": {...}}.  chip_smoke.py
checks both kernels bit for bit on the same inputs.  The script calls only
the public signatures of kmv_compose and kmv_compose_ds2, so copied with
experiments/common.py into an earlier checkout of the port, it times that
checkout's kernels on the same inputs in the same way.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from .common import card, graph_ms, rand_frames, time_ms

Y, X = 1080, 1920
#: one K=2 row of (mx, my) a stream: small and negative; out of frame;
#: stream 2 is unchanged; |mv| >= Y, X
MVK = [[[3, -5], [-7, 2]], [[-2000, 1500], [1925, -1085]],
       [[16, 16], [-16, 0]], [[0, Y], [-X, -2 * Y - 1]]]
#: kmv_compose_ds2's rows, the last one also out of range for Y + 1, X + 3
DS2_MVK = MVK[:3] + [[[0, 1081], [-1923, -2163]]]
CHANGED = [True, True, False, True]


def compose_inputs(device) -> tuple[torch.Tensor, ...]:
    """kmv_compose's B=4, K=2 step: random prev, paycode words of every
    ptype (0..3) and kslot (0..7: slots past K are motion without a vector)
    → (prev, paycode, mvk, changed) on `device`."""
    rng = np.random.default_rng(0)
    shape = (len(MVK), Y, X)
    prev = (rng.integers(0, 1 << 32, shape, dtype=np.uint64)
            .astype(np.uint32).view(np.int32))
    word = (rng.integers(0, 1 << 24, shape, dtype=np.uint32)
            | (rng.integers(0, 4, shape, dtype=np.uint32) << 24)
            | (rng.integers(0, 8, shape, dtype=np.uint32) << 26))
    return (torch.from_numpy(prev).to(device),
            torch.from_numpy(word.view(np.int32)).to(device),
            torch.tensor(MVK, dtype=torch.int32, device=device),
            torch.tensor(CHANGED, device=device))


def ds2_inputs(shape, seed: int, device) -> tuple[torch.Tensor, ...]:
    """kmv_compose_ds2's step of `shape` [B<=4, Y, X]: random prev, paycode
    words of ptype 0..3 and kslot 0..3 → (prev, paycode, mvk, changed)."""
    Bk = shape[0]
    prev = rand_frames(shape, device, 10 + seed)
    kind = (rand_frames(shape, device, 20 + seed) & (0x1F << 24)) \
        & ~(1 << 28)
    pc = (rand_frames(shape, device, 30 + seed) & 0x00FFFFFF) | kind
    return (prev, pc,
            torch.tensor(DS2_MVK[:Bk], dtype=torch.int32, device=device),
            torch.tensor(CHANGED[:Bk], device=device))


def time_kernels(device) -> dict:
    """{kernel: {"ms": CUDA events around 20 wrapper calls, "graph_ms":
    20 calls replayed as a CUDA graph}} at the B=4 1080p step."""
    from ..kernels.sp_recon import kmv_compose, kmv_compose_ds2

    prev, pc, mvk, chg = compose_inputs(device)
    out = torch.empty_like(prev)

    def compose():
        kmv_compose(prev, pc, mvk, chg, out=out)

    res = {"kmv_compose": dict(ms=time_ms(compose),
                               graph_ms=graph_ms(compose))}
    prev, pc, mvk, chg = ds2_inputs((4, Y, X), 0, device)
    out = torch.empty_like(prev)
    red = torch.empty((4, Y // 2, X // 2), dtype=torch.int32, device=device)

    def fused():
        kmv_compose_ds2(prev, pc, mvk, chg, out=out, red=red)

    res["kmv_compose_ds2"] = dict(ms=time_ms(fused), graph_ms=graph_ms(fused))
    return res


def main() -> None:
    device, line = card()
    print(json.dumps(dict(card=line, **time_kernels(device))), flush=True)


if __name__ == "__main__":
    main()

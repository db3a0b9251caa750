"""ds_probe's block_transpose mode (csrc/ds_probe.cu) at its script's shape:
its times as CUDA events around wrapper calls and as a CUDA graph, beside
the bytes it must move and torch's own transpose copy.

    python -m jsplayer_tpu_torch.experiments.probe_step

prints one JSON line: {"card": "<name>, <power limit>", "block_transpose":
{"ms": ..., "graph_ms": ..., "bytes": ..., "bound_ms": ..., "exact": ...},
"block_transpose_y1024": {...}, "torch_transpose_y1024": {...}}.  The
first is [4, 1080, 1920] with BH = 128 (a partial last block: rows past Y
read 0); the other two run on [4, 1024, 1920], a multiple of BH, where
``frames.reshape(C, n, BH, X).transpose(-1, -2).contiguous()`` computes
the same function in one PyTorch call.  `exact` holds the kernel against
the plain twin (experiments/probes.py), bit for bit.  The script calls
only ds_probe's public signature, so copied with experiments/common.py
into an earlier checkout of the port, it times that checkout's kernel on
the same inputs in the same way.
"""

from __future__ import annotations

import json

import torch

from .common import (HBM_BYTES_PER_MS, card, graph_ms, io_bytes, rand_frames,
                     time_ms)

C, Y, X, BH = 4, 1080, 1920, 128


def torch_block_transpose(frames: torch.Tensor, BH: int = BH) -> torch.Tensor:
    """block_transpose in one PyTorch call, for Y a multiple of BH."""
    Cn, Yn, Xn = frames.shape
    n = Yn // BH
    return frames.reshape(Cn, n, BH, Xn).transpose(-1, -2).contiguous() \
        .reshape(Cn, n * Xn, BH)


def torch_passthru(frames: torch.Tensor, BH: int = BH) -> torch.Tensor:
    """passthru (each block's top-left [BH/2, X/2]) in one PyTorch call,
    for Y a multiple of BH: a strided slice made contiguous."""
    Cn, Yn, Xn = frames.shape
    n = Yn // BH
    return frames.reshape(Cn, n, BH, Xn)[:, :, : BH // 2, : Xn // 2] \
        .contiguous().reshape(Cn, n * (BH // 2), Xn // 2)


def time_call(fn, want, nbytes) -> dict:
    """{"ms", "graph_ms", "bytes", "bound_ms", "exact"} of fn(), which
    must return `want`."""
    return dict(exact=torch.equal(fn(), want), ms=time_ms(fn),
                graph_ms=graph_ms(fn), bytes=nbytes,
                bound_ms=nbytes / HBM_BYTES_PER_MS)


def time_transpose(device) -> dict:
    from ..experiments.probes import probe_ref
    from ..kernels.ds_probe import ds_probe

    res = {}
    for name, rows in (("block_transpose", Y), ("block_transpose_y1024",
                                                 1024)):
        f = rand_frames((C, rows, X), device, 4)
        want = probe_ref(f, "block_transpose")
        out = torch.empty_like(want)
        res[name] = time_call(
            lambda: ds_probe(f, "block_transpose", BH, out=out), want,
            io_bytes(f, want))
        if rows % BH == 0:
            res["torch_transpose_y1024"] = time_call(
                lambda: torch_block_transpose(f), want, io_bytes(f, want))
    return res


def main() -> None:
    device, line = card()
    print(json.dumps(dict(card=line, **time_transpose(device))), flush=True)


if __name__ == "__main__":
    main()

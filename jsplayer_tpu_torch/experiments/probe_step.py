"""The ds_probe modes that one PyTorch call can match (csrc/ds_probe.cu:
block_transpose, passthru, hpair_i32, wpair_i32) at their scripts' shapes:
each one's times as CUDA events around wrapper calls and as a CUDA graph,
beside the bytes it must move and the PyTorch call.

    python -m jsplayer_tpu_torch.experiments.probe_step

prints one JSON line: {"card": "<name>, <power limit>", <mode>: {"ms": ...,
"graph_ms": ..., "bytes": ..., "bound_ms": ..., "exact": ...}, <mode>_y1024:
{...}, torch_<op>_y1024: {...}, ...}.  Each mode runs at its script's shape
with BH = 128 ([4, 1080, 1920]; passthru [64, 1080, 1920]: a partial last
block whose rows past Y read 0), then with 1024 rows, a multiple of BH,
where one PyTorch call computes the same function (torch_<op>, below).
`exact` holds each call against the plain twin (experiments/probes.py),
bit for bit; the row modes' entries (passthru, hpair_i32, wpair_i32) add
the instance that ran (null in a checkout whose ds_probe has none).  The
pair modes and their torch adds at 1024 rows add `cold_ms`, a call timed
alone after a 256 MB write has flushed the L2 (common.cold_ms), and
`cold_read_ms`, the same after a 256 MB read: their 47 MB working set is
about the L2's size, so `graph_ms` reads part of it from the L2 of the
replay before.  The bytes are each needed
input word read once and each output word written once
(probes.probe_read_words).  The script calls only ds_probe's public
signature, so copied with experiments/common.py into an earlier checkout
of the port, it times that checkout's kernels on the same inputs in the
same way.
"""

from __future__ import annotations

import json

import torch

from .common import (HBM_BYTES_PER_MS, card, cold_ms, graph_ms, io_bytes,
                     rand_frames, time_ms)

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


def torch_hpair_i32(frames: torch.Tensor, BH: int = BH) -> torch.Tensor:
    """hpair_i32 (wrapping int32 row-pair sums) in one PyTorch call, for Y
    a multiple of BH: the even rows added to the odd ones."""
    return torch.add(frames[:, 0::2], frames[:, 1::2])


def torch_wpair_i32(frames: torch.Tensor, BH: int = BH) -> torch.Tensor:
    """wpair_i32 (wrapping int32 column-pair sums) in one PyTorch call, for
    Y a multiple of BH and X even: the even columns added to the odd
    ones."""
    return torch.add(frames[..., 0::2], frames[..., 1::2])


#: mode → (its frame stack depth at its script's shape, the PyTorch call
#: that computes it where BH divides Y, that call's name in the output)
CALLS = {
    "block_transpose": (4, torch_block_transpose, "torch_transpose"),
    "passthru": (64, torch_passthru, "torch_passthru"),
    "hpair_i32": (4, torch_hpair_i32, "torch_hpair_i32"),
    "wpair_i32": (4, torch_wpair_i32, "torch_wpair_i32"),
}


#: the modes whose 1024-row readings add a cold-L2 time
PAIR_MODES = ("hpair_i32", "wpair_i32")
#: the modes with a 16-byte and a 4-byte instance
ROW_MODES = ("passthru", "hpair_i32", "wpair_i32")


def time_call(fn, want, nbytes, cold: bool = False) -> dict:
    """{"ms", "graph_ms", "bytes", "bound_ms", "exact"} of fn(), which
    must return `want`; with cold, also "cold_ms"."""
    res = dict(exact=torch.equal(fn(), want), ms=time_ms(fn),
               graph_ms=graph_ms(fn), bytes=nbytes,
               bound_ms=nbytes / HBM_BYTES_PER_MS)
    if cold:
        res["cold_ms"] = cold_ms(fn)
        res["cold_read_ms"] = cold_ms(fn, read=True)
    return res


def time_mode(mode: str, device) -> dict:
    """`mode` at its script's shape and at 1024 rows, and its PyTorch call
    at 1024 rows → {mode: ..., mode_y1024: ..., torch_<op>_y1024: ...}."""
    from ..experiments.probes import probe_read_words, probe_ref
    from ..kernels.ds_probe import ds_probe

    depth, library, lib_name = CALLS[mode]
    res = {}
    for name, rows in ((mode, Y), (f"{mode}_y1024", 1024)):
        f = rand_frames((depth, rows, X), device, depth + rows)
        want = probe_ref(f, mode)
        out = torch.empty_like(want)
        nbytes = 4 * probe_read_words(mode, *f.shape) + io_bytes(want)
        cold = mode in PAIR_MODES and rows % BH == 0
        res[name] = time_call(lambda: ds_probe(f, mode, BH, out=out), want,
                              nbytes, cold)
        if mode in ROW_MODES:
            res[name]["instance"] = getattr(ds_probe, "last_instance", None)
        if rows % BH == 0:
            res[f"{lib_name}_y1024"] = time_call(lambda: library(f), want,
                                                 nbytes, cold)
        del f, want, out
    return res


def main() -> None:
    device, line = card()
    res = dict(card=line)
    for mode in CALLS:
        res.update(time_mode(mode, device))
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()

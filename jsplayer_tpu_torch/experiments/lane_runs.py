"""Where the lane path's host time goes: chip_smoke.py's runs (h) (raw
payload) and (j) (rans payload), dense, frames and ds2 model tensors, on
block_step's four 1080p streams of 128 frames transcoded once by
transcode_to_lane(window=64, K=2), each run warm, then once under cProfile
and once under torch.profiler.

    python -m jsplayer_tpu_torch.experiments.lane_runs [--top 20]

prints one JSON line: {"card": "<name>, <power limit>", "raw": {...},
"rans": {...}}, each run {"wall_s" (synchronised, warm), "profiled_s",
"device_busy_s" (the kernels' and copies' device time in the traced run),
"own": [[function, own s, calls], ...], "cum": [[function, cumulative s,
calls], ...]}, the `top` functions by own and by cumulative time.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import os
import pstats
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from .block_step import screen_streams
from .common import card

WINDOW = 64


def containers(avis, payload: str) -> list[bytes]:
    """The streams transcoded to lane containers, a thread a stream."""
    from ..transcode import transcode_to_lane

    with ThreadPoolExecutor(len(avis)) as ex:
        return list(ex.map(lambda a: transcode_to_lane(
            a, window=WINDOW, K=2, payload=payload), avis))


def run(conts, device) -> float:
    """One dense lane run with frames and ds2 model tensors → wall s."""
    from .. import IngestConfig, MemorySource, VideoIngestPipeline

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe = VideoIngestPipeline(
        [MemorySource(c) for c in conts],
        IngestConfig(window=WINDOW, still_elision=False, model_downscale=2,
                     device=str(device), sp_device_path="lane"))
    n = sum(1 for _ in pipe)
    torch.cuda.synchronize()
    if not n or pipe.quarantined:
        raise RuntimeError(f"lane run: {n} windows, quarantined "
                           f"{pipe.quarantine_errors}")
    return time.perf_counter() - t0


def device_seconds(conts, device) -> float:
    """The device time of the kernels and copies of one run, traced."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(conts, device)
    total = 0.0
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        total += us
    return total / 1e6


def profiled(conts, device, top: int) -> dict:
    run(conts, device)  # warm: kernels built, pools made
    wall = run(conts, device)
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    run(conts, device)
    prof.disable()
    profiled_s = time.perf_counter() - t0
    stats = pstats.Stats(prof).stats

    def rows(key: int):
        order = sorted(stats.items(), key=lambda kv: -kv[1][key])[:top]
        return [[f"{os.path.join(*f.split(os.sep)[-2:])}:{line}({name})",
                 s[key], s[1]] for (f, line, name), s in order]

    return dict(wall_s=wall, profiled_s=profiled_s,
                device_busy_s=device_seconds(conts, device), own=rows(2),
                cum=rows(3))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--top", type=int, default=20)
    args = ap.parse_args()
    device, line = card()
    avis = screen_streams()[0]
    res = {payload: profiled(containers(avis, payload), device, args.top)
           for payload in ("raw", "rans")}
    print(json.dumps(dict(card=line, **res)), flush=True)


if __name__ == "__main__":
    main()

"""One run of one cell: set-up, the measured window, the judgement.

The window drives ``jsplayer_tpu_torch.VideoIngestPipeline`` over
``MemorySource``s of the cell's input bytes in a closed loop: one
consumer pulls windows as fast as they come, and each pass over the
inputs builds a new pipeline (so demux and keyframe probing are paid each
pass, as a user opening a batch of files pays them).  The consumer holds
each window until the next one arrives and adds no synchronise between
windows.  The window ends with the last window of the first pass that
ends at or after `seconds`, then ``torch.cuda.synchronize()``: the rate
is whole passes over the whole span.  A cut inside a pass would strand
work: the pipeline decodes window i+1 before it hands out window i, so
the window delivered at the cut has paid for one that is never counted
(one window in two of a pass of two).

Set-up, before it: the port's imports, its host library and kernels
(built into build/ at first use), the inputs from the seed, then one warm
pass over them, which runs every shape the window will.

Judged after it, once the peak memory is read and the pipeline is gone:
every window of one pass drawn from the seed (the first or the second,
or the last when the run made fewer) and of the last pass.
"""

from __future__ import annotations

import os
import time

import torch

from .inputs import make_inputs
from .judge import Judge, slots
from .trace import (GPU_CATS, Counters, Spans, idle_gaps, label_gaps,
                    read_trace, warn)


def _pipeline(cell, inputs, device):
    from jsplayer_tpu_torch import (IngestConfig, MemorySource,
                                    VideoIngestPipeline)

    cfg = IngestConfig(**cell.ingest_fields(), device=str(device))
    return VideoIngestPipeline([MemorySource(c) for c in inputs.containers],
                               cfg)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Window:
    """The closed loop's tallies."""

    def __init__(self):
        self.frames = 0
        self.windows = 0
        self.passes = 0
        self.quarantined = 0  # timeline frames of quarantined streams
        self.coded_bytes = 0
        self.out_bytes = 0
        self.held: dict = {}  # pass -> its windows, for the judge
        self.pass_s: list = []  # each pass's seconds


def drive(cell, inputs, device, seconds, keep: int, tally: Window) -> None:
    """Whole passes until one ends at or after `seconds` (one pass when
    `seconds` is None).  Windows of pass `keep` and of the last pass stay
    held in tally.held."""
    T = cell.config["frames"]
    B = len(inputs.containers)
    t0 = time.perf_counter()
    while True:
        p = tally.passes
        tp = time.perf_counter()
        pipe = _pipeline(cell, inputs, device)
        it = iter(pipe)
        tally.held[p] = []
        try:
            for w in it:
                n = slots(w, T)
                s = int(w["start_frame"])
                tally.frames += B * n
                tally.windows += 1
                tally.coded_bytes += int(sum(c[s:s + n].sum()
                                             for c in inputs.coded))
                tally.out_bytes += sum(
                    w[k].numel() * w[k].element_size()
                    for k in ("frames_u32", "model_input") if k in w)
                tally.held[p].append(w)
                if p - 1 != keep:
                    # the window before has now been replaced: the last
                    # pass's windows are held only until this one arrives
                    tally.held.pop(p - 1, None)
        finally:
            it.close()
        q = getattr(pipe, "quarantined", set())
        tally.quarantined += len(q) * T
        if q:
            warn(f"pass {p}: streams {sorted(q)} quarantined: "
                 f"{getattr(pipe, 'quarantine_errors', [])[:4]}")
        del pipe, it
        tally.passes += 1
        tally.pass_s.append(time.perf_counter() - tp)
        if seconds is None or time.perf_counter() - t0 >= seconds:
            return


def _require_native() -> None:
    from jsplayer_tpu_torch import native

    if not native.available():
        raise RuntimeError("the port's native host library did not build or "
                           "load (g++ into build/): the pipeline would fall "
                           "back to the pure-Python oracle")


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str,
             t_start: float, inputs=None) -> dict:
    """One run → {"metrics", "checks", "correct", "attempted", "failed",
    "device", "breakdown", "setup", "window", "judge"} (metrics as
    BENCHMARK.json names them, values unrounded).  `t_start`:
    perf_counter at the process's start; `inputs`: the seed's, when the
    caller made them already."""
    _require_native()
    dev = torch.device(device)
    if inputs is None:
        inputs = make_inputs(cell, seed)
    setup = {f"inputs_{k}_s": v for k, v in inputs.seconds.items()}
    t = time.perf_counter()
    warm = Window()
    drive(cell, inputs, dev, None, 0, warm)
    _sync(dev)
    del warm
    setup["warm_pass_s"] = time.perf_counter() - t
    keep = seed % 2
    tally = Window()
    spans = counters = prof = None
    if trace:
        # every span set: those no metric reads still name the idle gaps
        spans = Spans(cell.bench, cell.bench.names("spans"))
        counters = Counters(cell.bench, sorted(
            {s for m in cell.bench.metrics(cell.name, "per_layer")
             for s in _reader(cell, m["name"]).COUNTERS}))
        spans.install()
        counters.reset()
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        prof.__enter__()
    cpu0 = os.times()
    w0 = time.perf_counter()
    setup_s = w0 - t_start
    if trace:
        ann = torch.profiler.record_function("portbench.window")
        ann.__enter__()
        host0_ns = time.perf_counter_ns()
    drive(cell, inputs, dev, seconds, keep, tally)
    _sync(dev)
    w1 = time.perf_counter()
    cpu1 = os.times()
    if trace:
        ann.__exit__(None, None, None)
        prof.__exit__(None, None, None)
        spans.uninstall()
    window_s = w1 - w0
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    cpu_s = (cpu1[0] - cpu0[0]) + (cpu1[1] - cpu0[1])
    res = {
        "attempted": tally.frames, "failed": min(tally.quarantined,
                                                 tally.frames),
        "window": {"seconds": window_s, "frames": tally.frames,
                   "windows": tally.windows, "passes": tally.passes,
                   "cpu_s": cpu_s, "pass_s": tally.pass_s},
        "setup": {"setup_s": setup_s, **setup},
        "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": cell.chips, "memory_peak_bytes": int(peak)},
    }
    if not trace:
        res["metrics"] = {
            "delivered_fps": tally.frames / window_s,
            "host_cpu_ms_per_frame": 1e3 * cpu_s / max(tally.frames, 1),
            "setup_s": setup_s}
    else:
        tr = read_trace(prof)
        offset_us = tr["w0"] - host0_ns / 1e3
        busy_us = float((tr["busy"][:, 1] - tr["busy"][:, 0]).sum())
        gaps = idle_gaps(tr["busy"], tr["w0"], tr["w1"])
        ctx = Context(cell=cell, spans=spans, launches=counters.read(),
                      trace=tr, frames=tally.frames, window_s=window_s,
                      coded_bytes=tally.coded_bytes,
                      out_bytes=tally.out_bytes)
        res["metrics"] = {}
        for m in cell.bench.metrics(cell.name, "per_layer"):
            v = _reader(cell, m["name"]).read(ctx)
            if v is None:
                warn(f"{m['name']}: nothing to read in this run")
            else:
                res["metrics"][m["name"]] = float(v)
        res["device"]["busy_s"] = busy_us / 1e6
        res["device"]["window_s"] = (tr["w1"] - tr["w0"]) / 1e6
        ops = sorted(tr["by_name"].items(), key=lambda kv: -kv[1])[:10]
        idle = sorted(label_gaps(gaps, spans, offset_us).items(),
                      key=lambda kv: -kv[1])[:10]
        res["breakdown"] = {
            "device_ops": [[k[:160], v / 1e6] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in idle]}
        del prof, tr
    held = tally.held
    del tally
    judge = Judge(inputs.frames, cell.config,
                  cell.bench.module("references", cell.config["reference"]),
                  dev)
    t = time.perf_counter()
    T = cell.config["frames"]
    for p in sorted(held):
        for w in held[p]:
            judge.window(w, T)
        judge.coverage(held[p], T)
    del held
    res["judge"] = {"windows": judge.windows,
                    "seconds": time.perf_counter() - t}
    res["checks"] = judge.checks()
    res["correct"] = judge.correct() and res["failed"] == 0
    return res


class Context:
    """What a per-layer metric's reader sees (metrics/<name>.py)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def peaks(self) -> dict:
        return self.cell.bench.data("peaks", "h100_sxm")

    def device_seconds(self, cats=GPU_CATS, name_has=None) -> float:
        """Seconds of the window's device events of categories `cats`
        (and whose name holds `name_has`), each clipped to the window."""
        tr = self.trace
        s = 0.0
        for e, (a, b) in zip(tr["events"], tr["iv"]):
            if e["cat"] in cats and (name_has is None or name_has in e["name"]):
                s += b - a
        return s / 1e6


def _reader(cell, name: str):
    return cell.bench.module("metrics", name)

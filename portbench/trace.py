"""What a traced run reads: spans, counters and the device trace.

Spans come from the benchmark's own files: ``spans/<set>.json`` lists port
functions as "module:attr.path", and ``Spans.install`` wraps each in the
namespace its caller resolves it from (a module attribute or a class
attribute), timing every call on the host clock.  A name that is no longer
there leaves its set broken: the metrics that read the set give nothing,
with a warning, and the run goes on.  ``counters/<set>.json`` lists port
wrappers whose ``.launches`` the run reads.

The device trace is torch.profiler's (CPU and CUDA activity, every card
the process uses) over the measured window, exported as a Chrome trace
into a temporary file that is read once and deleted.  A ``portbench.window`` annotation marks the window
in it and ties the trace's clock to the host's.
"""

from __future__ import annotations

import functools
import importlib
import json
import os
import sys
import tempfile
import time

import numpy as np

GPU_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def warn(msg: str) -> None:
    print(f"portbench: warning: {msg}", file=sys.stderr, flush=True)


def _resolve(name: str):
    """ "pkg.mod:Cls.attr" → (owner object, attribute name)."""
    mod, _, attr = name.partition(":")
    owner = importlib.import_module(mod)
    *path, last = attr.split(".")
    for p in path:
        owner = getattr(owner, p)
    getattr(owner, last)  # AttributeError when the name has gone
    return owner, last


class Spans:
    """Host-clock spans around the port functions of the span sets."""

    def __init__(self, bench, sets: list):
        self.bench = bench
        self.sets = sets
        self.records: list = []  # (set, label, t0_ns, t1_ns)
        self.broken: set = set()
        self._undo: list = []

    def install(self) -> None:
        for s in self.sets:
            names = self.bench.data("spans", s)["names"]
            for name in names:
                try:
                    owner, attr = _resolve(name)
                except (ImportError, AttributeError) as e:
                    warn(f"span set {s!r}: {name} is not there ({e!r}); "
                         f"its metrics give nothing")
                    self.broken.add(s)
                    continue
                raw = getattr(owner, attr)
                self._undo.append((owner, attr, raw))
                setattr(owner, attr, self._wrap(s, attr, raw))

    def _wrap(self, s, label, fn):
        rec = self.records
        clock = time.perf_counter_ns

        @functools.wraps(fn)
        def timed(*a, **kw):
            t0 = clock()
            try:
                return fn(*a, **kw)
            finally:
                rec.append((s, label, t0, clock()))

        return timed

    def uninstall(self) -> None:
        for owner, attr, raw in reversed(self._undo):
            setattr(owner, attr, raw)
        self._undo.clear()

    def seconds(self, s: str):
        """Summed seconds of set `s`'s spans, or None when the set is broken
        or never ran (outer spans only: a set's nested calls count once)."""
        if s in self.broken:
            return None
        iv = sorted((r[2], r[3]) for r in self.records if r[0] == s)
        if not iv:
            return None
        total, end = 0, None
        for a, b in iv:
            if end is None or a >= end:
                total += b - a
                end = b
            elif b > end:
                total += b - end
                end = b
        return total / 1e9


class Counters:
    """The `.launches` of the port wrappers in counters/<set>.json."""

    def __init__(self, bench, sets: list):
        self.wrappers = {}
        for s in sets:
            for name in bench.data("counters", s)["names"]:
                try:
                    owner, attr = _resolve(name)
                except (ImportError, AttributeError) as e:
                    warn(f"counter {name} is not there ({e!r})")
                    continue
                self.wrappers[name] = getattr(owner, attr)

    def reset(self) -> None:
        for w in self.wrappers.values():
            w.launches = 0

    def read(self) -> dict:
        return {k: int(getattr(w, "launches", 0))
                for k, w in self.wrappers.items()}


def _union(iv: np.ndarray) -> np.ndarray:
    """Sorted, merged [start, end) intervals of an [N, 2] array."""
    if not len(iv):
        return iv.reshape(0, 2)
    iv = iv[np.argsort(iv[:, 0])]
    out = [list(iv[0])]
    for a, b in iv[1:]:
        if a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return np.array(out)


def read_trace(prof) -> dict:
    """The profiler's Chrome trace → device events in the window (us, on
    the trace's clock), each event's card, the window's bounds, the merged
    busy intervals over every card and on each card, and per-name device
    time."""
    fd, path = tempfile.mkstemp(prefix="portbench-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    win = [e for e in events if e.get("name") == "portbench.window"
           and e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError("the trace has no portbench.window annotation")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    gpu = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in GPU_CATS]
    iv = np.array([[float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))]
                   for e in gpu] or np.zeros((0, 2)), dtype=np.float64)
    iv = np.clip(iv, w0, w1)
    by_name: dict = {}
    for e, (a, b) in zip(gpu, iv):
        name = e["name"]
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    card = np.array([_card(e) for e in gpu], dtype=np.int64)
    live = iv[:, 1] > iv[:, 0]
    return {"w0": w0, "w1": w1, "events": gpu, "iv": iv, "card": card,
            "busy": _union(iv[live]),
            "busy_by_card": {int(k): _union(iv[live & (card == k)])
                             for k in np.unique(card)},
            "by_name": by_name}


def _card(e: dict) -> int:
    """The card a device event ran on: Kineto's args.device, else its
    pid (a device event's pid is its device index)."""
    d = e.get("args", {}).get("device")
    return int(e["pid"] if d is None else d)


def idle_gaps(busy: np.ndarray, w0: float, w1: float) -> np.ndarray:
    """[N, 2] gaps of the window (us) where no device operation ran."""
    edges = np.concatenate([[w0], busy.reshape(-1), [w1]]).reshape(-1, 2)
    return edges[edges[:, 1] > edges[:, 0]]


def label_gaps(gaps: np.ndarray, spans: Spans, offset_us: float,
               min_us: float = 100.0) -> dict:
    """Idle seconds by the innermost benchmark span open on the host at
    each gap's middle ("outside spans" when none is); gaps under `min_us`
    are summed under "gaps under 0.1 ms"."""
    out: dict = {}
    if not len(gaps):
        return out
    rec = spans.records
    st = np.array([r[2] for r in rec], dtype=np.float64) / 1e3 + offset_us
    en = np.array([r[3] for r in rec], dtype=np.float64) / 1e3 + offset_us
    labels = [f"{r[0]}:{r[1]}" for r in rec]
    for a, b in gaps:
        d = (b - a) / 1e6
        if b - a < min_us:
            out["gaps under 0.1 ms"] = out.get("gaps under 0.1 ms", 0.0) + d
            continue
        m = (a + b) / 2
        hit = np.nonzero((st <= m) & (en > m))[0]
        lab = labels[hit[np.argmax(st[hit])]] if len(hit) else "outside spans"
        out[lab] = out.get(lab, 0.0) + d
    return out

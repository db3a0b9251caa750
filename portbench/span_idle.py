"""One traced run of a cell, read against the port's own spans.

    python3 portbench/span_idle.py --workload <name> --seed <n> \
        --seconds <s> --out <dir>
    python3 portbench/span_idle.py --read <dir>/<workload>-<seed>.trace.json.gz

The first form, from the root of a checkout on the GPU machine, runs the
cell as ``run.py --trace 1`` does (on its cards counted up from
``--device``, cuda:0 by default), keeps the window's Chrome trace
(``<dir>/<workload>-<seed>.trace.json.gz``) and prints one JSON line with
the run's ``metrics``, ``window`` and ``device`` as run.py gives them,
``program`` (the port's TRACE.summary()) and the reduction of the trace
below.  The second prints the reduction of a kept trace:

  * ``idle_by_span``: the card's idle seconds in the window, each instant
    of a gap labelled with the innermost ``jsp.*`` annotation open then
    ("no jsp span" where none is; gaps under 0.1 ms apart), and
    ``unlabelled_share``, the "no jsp span" seconds over all idle seconds;
  * ``htod_bytes``: the summed ``args.bytes`` of the window's HtoD memcpy
    events (beside the port's ``upload.bytes`` in the first form);
  * ``trace_total_s``: each ``jsp.*`` annotation's summed duration.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import shutil
import sys
import time

_T0 = time.perf_counter()

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(HERE)


def jsp_spans(events) -> list:
    """[(ts, end, name)] of the trace's jsp.* annotations (us)."""
    return [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
             e["name"]) for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and str(e.get("name", "")).startswith("jsp.")]


def innermost(spans) -> list:
    """Nested spans → [(a, b, name)]: disjoint pieces of time, each
    labelled with the innermost span open there (the latest opened)."""
    edges = sorted([(s[1], 0, i) for i, s in enumerate(spans)]
                   + [(s[0], 1, i) for i, s in enumerate(spans)])
    out, open_, t = [], [], None
    for x, is_start, i in edges:
        if open_ and x > t:
            out.append((t, x, spans[open_[-1]][2]))
        if is_start:
            open_.append(i)
        else:
            open_.remove(i)
        t = x
    return out


def idle_by_span(gaps, spans, min_us: float = 100.0) -> dict:
    """Idle seconds of the gaps by the innermost jsp span open at each
    instant; gaps under `min_us` are summed apart."""
    import numpy as np

    seg = innermost(spans)
    a0 = np.array([s[0] for s in seg], dtype=np.float64)
    b0 = np.array([s[1] for s in seg], dtype=np.float64)
    out: dict = {}
    for a, b in gaps:
        if b - a < min_us:
            out["gaps under 0.1 ms"] = (out.get("gaps under 0.1 ms", 0.0)
                                        + (b - a) / 1e6)
            continue
        left = b - a
        for k in range(np.searchsorted(b0, a, "right"),
                       np.searchsorted(a0, b)):
            d = min(b, b0[k]) - max(a, a0[k])
            if d > 0:
                out[seg[k][2]] = out.get(seg[k][2], 0.0) + d / 1e6
                left -= d
        if left > 0:
            out["no jsp span"] = out.get("no jsp span", 0.0) + left / 1e6
    return out


def htod_bytes(events, w0: float, w1: float) -> int:
    """Summed args.bytes of the HtoD memcpy events that start in the
    window."""
    return int(sum(int(e.get("args", {}).get("bytes", 0)) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "gpu_memcpy"
                   and "HtoD" in e.get("name", "")
                   and w0 <= float(e["ts"]) < w1))


def reduce_trace(events) -> dict:
    """A traced window's Chrome trace events → its idle seconds by jsp
    span, HtoD bytes and jsp span totals (see the module's docstring)."""
    import numpy as np

    from portbench.trace import GPU_CATS, _union, idle_gaps

    win = next(e for e in events if e.get("name") == "portbench.window"
               and e.get("ph") == "X")
    w0 = float(win["ts"])
    w1 = w0 + float(win["dur"])
    iv = np.array([[float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))]
                   for e in events if e.get("ph") == "X"
                   and e.get("cat") in GPU_CATS] or np.zeros((0, 2)))
    iv = np.clip(iv, w0, w1)
    gaps = idle_gaps(_union(iv[iv[:, 1] > iv[:, 0]]), w0, w1)
    spans = [s for s in jsp_spans(events) if s[1] > w0 and s[0] < w1]
    idle = idle_by_span(gaps, spans)
    idle_s = sum(idle.values())
    totals: dict = {}
    for a, b, n in spans:
        totals[n] = totals.get(n, 0.0) + (b - a) / 1e6
    return {"idle_s": idle_s,
            "idle_by_span": dict(sorted(idle.items(), key=lambda kv: -kv[1])),
            "unlabelled_share": (idle.get("no jsp span", 0.0) / idle_s
                                 if idle_s else None),
            "htod_bytes": htod_bytes(events, w0, w1),
            "trace_total_s": totals}


def _run(args) -> dict:
    from portbench import harness
    from portbench.program import summary
    from portbench.run import keep_freed_heap, missing_cards
    from portbench.spec import Bench

    keep_freed_heap()  # as run.py's runs do
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out,
                        f"{args.workload}-{args.seed}.trace.json.gz")
    raw = path[:-3]
    kept: dict = {}
    read_trace = harness.read_trace

    class Exported:
        """The profiler's trace, exported once (a profiler exports only
        once), for harness.read_trace to export again."""

        def export_chrome_trace(self, dst):
            shutil.copyfile(raw, dst)

    def keep(prof):
        prof.export_chrome_trace(raw)
        with open(raw) as f:
            kept["events"] = json.load(f)["traceEvents"]
        tr = read_trace(Exported())
        with open(raw, "rb") as f, gzip.open(path, "wb") as g:
            shutil.copyfileobj(f, g)
        os.remove(raw)
        return tr

    harness.read_trace = keep
    cell = Bench(CHECKOUT).cell(args.workload)
    missing = missing_cards(cell, args.device)
    if missing:
        raise SystemExit(f"portbench: {missing}")
    res = harness.run_cell(cell, args.seed, args.seconds, True, args.device,
                           _T0)
    prog = summary() or {}
    red = reduce_trace(kept["events"])
    up = prog.get("counters", {}).get("upload.bytes")
    return {"workload": cell.name, "seed": args.seed,
            "correct": bool(res["correct"]), "metrics": res["metrics"],
            "window": res["window"], "device": res["device"], **red,
            "upload_bytes": up,
            "upload_over_htod": (up / red["htod_bytes"]
                                 if up and red["htod_bytes"] else None),
            "program": prog, "breakdown": res.get("breakdown"),
            "trace": path}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int)
    ap.add_argument("--seconds", type=float)
    ap.add_argument("--out")
    ap.add_argument("--device", default="cuda:0",
                    help="the cell's first card")
    ap.add_argument("--read", help="a kept trace (.trace.json.gz) to reduce")
    args = ap.parse_args(argv)
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
    if CHECKOUT not in sys.path:
        sys.path.insert(0, CHECKOUT)
    from portbench.run import _paths

    _paths()
    if args.read:
        with gzip.open(args.read, "rt") as f:
            out = reduce_trace(json.load(f)["traceEvents"])
    elif None in (args.workload, args.seed, args.seconds, args.out):
        ap.error("give --workload, --seed, --seconds and --out, or --read")
    else:
        out = _run(args)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

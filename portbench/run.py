"""Run one cell of the benchmark of jsplayer_tpu_torch once, on its cards.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1> [--device cuda:<k>]

from the root of a checkout.  BENCHMARK.json names the cells.  A cell
runs in this one process on the `chips` cards it asks for, counted up
from `--device` (cuda:0 by default); a configuration that names a mesh
puts slot s on card s % chips.  The run
makes the cell's inputs from the seed, warms up on one pass over them,
measures for `seconds` (portbench/harness.py), judges what the window
delivered against the plain reference, and prints as the last line of its
standard output one JSON object: "correct", "attempted", "failed",
"metrics" (the cell's end-to-end metrics, or with --trace 1 its per-layer
metrics, each {"value", "unit"}), "device", with --trace 1 "breakdown",
then "setup", "window", "judge" and, last, "checks": each number
compared beside its limit, which are also the last lines of its standard
error.

It exits non-zero and prints no result when torch sees no CUDA card or
fewer than the cell asks for, when the port cannot be imported (a
directory holding only BENCHMARK.json and portbench/), and when a module
of JAX or of the JAX package is loaded once the window has closed.
Builds stay inside the checkout: the port's under build/, the
benchmark's encoder under build/portbench/, and the Triton and torch
extension caches under build/portbench/ too.

The process keeps the heap it frees (`keep_freed_heap`): what the port
frees between windows is reused in place instead of going back to the
kernel.  The card's machine runs the benchmark under a user-space kernel
(gVisor), where a page given back and touched again is a fault that
kernel serves, at a cost that wandered from run to run.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()  # the process's start, as set-up counts it

import argparse  # noqa: E402
import ctypes  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(HERE)


def _paths() -> None:
    """Import the benchmark as the package `portbench` from the checkout's
    root, never its files as top-level modules."""
    sys.path[:] = [p for p in sys.path
                   if os.path.abspath(p or ".") != HERE]
    if CHECKOUT not in sys.path:
        sys.path.insert(0, CHECKOUT)
    cache = os.path.join(CHECKOUT, "build", "portbench")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")


M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3  # glibc's mallopt parameters


def keep_freed_heap() -> bool:
    """Raise glibc's mmap threshold to 1 GiB and its trim threshold to
    2 GiB - 1 for this process, so that arrays below 1 GiB come from the
    heap and the heap is never given back: True where glibc took both.
    MSVideo1 16-bit QVGA on one H100 host, six 51 s runs each way in
    turns: 2,558 frames/s median and a quartile spread of 12.2% with
    glibc's defaults, 3,235 and 8.3% with these."""
    try:
        mallopt = ctypes.CDLL("libc.so.6").mallopt
    except (OSError, AttributeError):
        return False
    return bool(mallopt(M_MMAP_THRESHOLD, 1 << 30)
                and mallopt(M_TRIM_THRESHOLD, (1 << 31) - 1))


def missing_cards(cell, device: str):
    """Why the cell cannot run from CUDA card `device` (the cell's `chips`
    cards counted up from it), or None when it can.  The CPU, which the
    tests give readings.py and span_idle.py, needs no card."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
    first = dev.index or 0
    if seen < first + cell.chips:
        return (f"{cell.name} needs {cell.chips} CUDA card(s) from "
                f"{device}; torch {torch.__version__} sees {seen}")
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default="cuda:0",
                    help="the cell's first card")
    args = ap.parse_args(argv)
    heap_kept = keep_freed_heap()
    _paths()
    from portbench.nojax import forbidden
    from portbench.spec import Bench

    bench = Bench(CHECKOUT)
    cell = bench.cell(args.workload)
    missing = (missing_cards(cell, args.device)
               if args.device.startswith("cuda") else
               f"--device {args.device} is no CUDA card")
    if missing:
        print(f"portbench: {missing}", file=sys.stderr)
        return 2
    from portbench.harness import run_cell

    res = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   args.device, _T0)
    bad = forbidden()
    if bad:
        print(f"portbench: modules of {bad} were loaded in this process",
              file=sys.stderr)
        return 3
    units = {m["name"]: m["unit"]
             for m in bench.spec["end_to_end"] + bench.spec["per_layer"]}
    out = {"correct": bool(res["correct"]), "attempted": res["attempted"],
           "failed": res["failed"],
           "metrics": {k: {"value": v, "unit": units[k]}
                       for k, v in res["metrics"].items()},
           "device": res["device"]}
    if "breakdown" in res:
        out["breakdown"] = res["breakdown"]
    out.update(workload=cell.name, seed=args.seed,
               setup={**res["setup"], "heap_kept": heap_kept},
               window=res["window"], judge=res["judge"],
               checks=res["checks"])
    sys.stdout.flush()
    for k, c in res["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

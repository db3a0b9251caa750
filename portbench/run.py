"""Run one cell of the benchmark of jsplayer_tpu_torch once, on one card.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  BENCHMARK.json names the cells.  The run
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
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()  # the process's start, as set-up counts it

import argparse  # noqa: E402
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _paths()
    import torch

    from portbench.nojax import forbidden
    from portbench.spec import Bench

    bench = Bench(CHECKOUT)
    cell = bench.cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"torch {torch.__version__} sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from portbench.harness import run_cell

    res = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0",
                   _T0)
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
    out.update(workload=cell.name, seed=args.seed, setup=res["setup"],
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

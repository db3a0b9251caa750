"""The readings that set the limits of `correct`, for one cell on the card.

    python3 portbench/readings.py --workload <name> --seconds <s> \
        --seeds <n> [<n> ...] [--control-seeds <n> ...]

In one process, for each seed: the cell's inputs, one run of the program
as the benchmark runs it (set-up, a window of `seconds`, the judgement;
on the cell's cards counted up from `--device`, cuda:0 by default),
and for each control seed the reference's control (references/<name>.py,
one precision below the configuration) put in the program's place over a
whole pass and judged the same way, its audio (``control_audio``) too
where the configuration has a track.  One JSON line a seed on standard
output, then a summary line: each number's largest program reading and
smallest control reading.  The benchmark's own runs never run the control.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda:0",
                    help="the cell's first card")
    ap.add_argument("--checkout", default=None,
                    help="another checkout's BENCHMARK.json and data")
    args = ap.parse_args(argv)
    if CHECKOUT not in sys.path:
        sys.path.insert(0, CHECKOUT)
    from portbench.run import _paths, missing_cards

    _paths()
    from portbench.harness import run_cell
    from portbench.inputs import FPS, make_inputs
    from portbench.judge import Judge, control_windows
    from portbench.spec import Bench

    cell = Bench(args.checkout or CHECKOUT).cell(args.workload)
    missing = missing_cards(cell, args.device)
    if missing:
        ap.error(missing)
    ref = cell.bench.module("references", cell.config["reference"])
    prog, ctl = {}, {}
    for seed in dict.fromkeys(args.seeds + args.control_seeds):
        inputs = make_inputs(cell, seed)
        line = {"workload": cell.name, "seed": seed}
        if seed in args.seeds:
            res = run_cell(cell, seed, args.seconds, False, args.device,
                           time.perf_counter(), inputs=inputs)
            line.update(correct=res["correct"], failed=res["failed"],
                        program={k: c["value"]
                                 for k, c in res["checks"].items()},
                        fps=res["metrics"]["delivered_fps"],
                        window=res["window"], judge=res["judge"])
            for k, v in line["program"].items():
                prog[k] = max(prog.get(k, 0), v)
        if seed in args.control_seeds:
            j = Judge(inputs.frames, cell.config, ref, args.device,
                      audio=inputs.audio)
            for w in control_windows(inputs.frames, cell.config, ref,
                                     args.device,
                                     cell.config["ingest"]["window"]):
                j.window(w, cell.config["frames"])
            if cell.config.get("audio"):
                j.audio([ref.control_audio(a, cell.config["audio"], FPS)
                         for a in inputs.audio])
            line["control"] = {k: c["value"] for k, c in j.checks().items()}
            line["control_correct"] = j.correct()
            for k, v in line["control"].items():
                ctl[k] = min(ctl.get(k, v), v)
        print(json.dumps(line), flush=True)
    print(json.dumps({"workload": cell.name, "program_max": prog,
                      "control_min": ctl, "limits": ref.LIMITS,
                      "seconds": time.perf_counter() - _T0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

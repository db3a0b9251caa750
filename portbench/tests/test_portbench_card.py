"""On the card: each cell at a tiny size through the real kernels is
correct, and the control is not.  Run on the GPU machine with

    python -m pytest -p no:cacheprovider portbench/tests -q -m cuda
"""

from __future__ import annotations

import time

import pytest

from portbench.harness import run_cell
from portbench.judge import Judge, control_windows
from portbench.spec import CHECKOUT, Bench

WORKLOADS = [w["name"] for w in Bench(CHECKOUT).spec["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_on_the_card(tiny_checkout, card, workload):
    from portbench.inputs import make_inputs

    cell = Bench(tiny_checkout).cell(workload)
    inp = make_inputs(cell, 9)
    res = run_cell(cell, 9, 0.5, True, card, time.perf_counter(),
                   inputs=inp)
    assert res["correct"], res["checks"]
    assert res["device"]["busy_s"] > 0
    assert 0 < res["metrics"]["kernels_roofline"] <= 105
    ref = cell.bench.module("references", cell.config["reference"])
    ctl = Judge(inp.frames, cell.config, ref, card)
    for w in control_windows(inp.frames, cell.config, ref, card,
                             cell.config["ingest"]["window"]):
        ctl.window(w, cell.config["frames"])
    assert not ctl.correct()

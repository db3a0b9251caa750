"""On the card: each cell at a tiny size through the real kernels is
correct, and the control is not; a cell on a dp=4 mesh is correct with
its four slots on one card, and on four cards where there are four.  Run
on the GPU machine with

    python -m pytest -p no:cacheprovider portbench/tests -q -m cuda
"""

from __future__ import annotations

import shutil
import time

import pytest
import torch

from portbench.harness import run_cell
from portbench.judge import Judge, control_windows
from portbench.spec import CHECKOUT, Bench
from test_portbench_mesh import CELL, add_mesh_cell

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


def _mesh_run(tiny_checkout, tmp_path, card, chips: int) -> dict:
    co = str(tmp_path / "co")
    shutil.copytree(tiny_checkout, co)
    add_mesh_cell(co, chips=chips)
    res = run_cell(Bench(co).cell(CELL), 13, 0.5, True, card,
                   time.perf_counter())
    assert res["correct"], res["checks"]
    dev = res["device"]
    assert dev["count"] == chips
    assert len(dev["memory_peak_bytes_by_card"]) == chips
    assert dev["memory_peak_bytes"] == max(dev["memory_peak_bytes_by_card"])
    return dev


@pytest.mark.cuda
def test_mesh_cell_on_one_card(tiny_checkout, tmp_path, card):
    """Four slots of a dp=4 mesh on one card (make_mesh allows a device
    to repeat): correct, busy time on that card alone."""
    dev = _mesh_run(tiny_checkout, tmp_path, card, 1)
    assert list(dev["busy_s_by_card"]) == [str(torch.device(card).index)]
    assert dev["busy_s"] == dev["busy_s_by_card"][
        str(torch.device(card).index)] > 0


@pytest.mark.cuda
def test_mesh_cell_on_four_cards(tiny_checkout, tmp_path, card):
    """A slot a card: correct, with busy time and a peak on each card."""
    first = torch.device(card).index
    if torch.cuda.device_count() < first + 4:
        pytest.skip(f"needs four cards from {card}; torch sees "
                    f"{torch.cuda.device_count()}")
    dev = _mesh_run(tiny_checkout, tmp_path, card, 4)
    assert sorted(dev["busy_s_by_card"]) == [str(first + k)
                                             for k in range(4)]
    assert all(v > 0 for v in dev["busy_s_by_card"].values())
    assert all(v > 0 for v in dev["memory_peak_bytes_by_card"])

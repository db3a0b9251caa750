"""Whole runs of each cell at a tiny size on the CPU, with the timed path
broken underneath: `correct` has to come out false for each fault a cell
can have (a scan step that returns its state unchanged; half of the batch
left out of the step; an answer altered where it is produced), and true
with nothing broken.  These cells run on one card, with no exchange
between cards to leave out; a cell on a mesh has that fault too, and
test_portbench_mesh.py breaks it there."""

from __future__ import annotations

import time

import pytest
import torch

from portbench.harness import run_cell
from portbench.spec import CHECKOUT, Bench

BENCH = Bench(CHECKOUT)


def _scan_entry(workload: str) -> tuple:
    """(module of jsplayer_tpu_torch.kernels, function) of the cell's scan."""
    cell = BENCH.cell(workload)
    if cell.config["codec"].startswith("msv1"):
        return "msv1_paint", "decode_batch"
    return {"kmv": ("sp_recon", "kmv_compose"),
            "lane": ("lane_recon", "decode_batch_lane")}[
        cell.ingest_fields()["sp_device_path"]]


def _broken(fault, raw, step):
    """The scan entry `raw`, broken by `fault`.  `step`: True for a
    one-step entry (out [B, Y, X] from prev), False for a window entry
    (its frames [B, T, Y, X], first argument the carry-in [B, Y, X])."""

    def frames_of(out):
        return out[0] if isinstance(out, tuple) else out

    def call(*a, **kw):
        out = raw(*a, **kw)
        fr = frames_of(out)
        prev = a[0] if step else a[0][:, None]
        B = fr.shape[0]
        if fault == "state_unchanged":
            fr.copy_(prev.expand_as(fr))
        elif fault == "half_batch":
            fr[B // 2:] = prev[B // 2:].expand_as(fr[B // 2:])
        elif fault == "answer_altered":
            fr[(0,) + tuple(n // 2 for n in fr.shape[1:])] ^= 1
        return out

    return call


@pytest.mark.parametrize("fault", [None, "state_unchanged", "half_batch",
                                   "answer_altered"])
@pytest.mark.parametrize("workload",
                         [w["name"] for w in BENCH.spec["workloads"]])
def test_fault_is_caught(tiny_checkout, monkeypatch, workload, fault):
    import importlib

    mod_name, fn = _scan_entry(workload)
    mod = importlib.import_module(f"jsplayer_tpu_torch.kernels.{mod_name}")
    if fault is not None:
        monkeypatch.setattr(mod, fn, _broken(fault, getattr(mod, fn),
                                             fn == "kmv_compose"))
    cell = Bench(tiny_checkout).cell(workload)
    with torch.no_grad():
        res = run_cell(cell, 5, 0.3, False, "cpu", time.perf_counter())
    assert res["correct"] is (fault is None), res["checks"]
    if fault is not None:
        assert res["checks"]["frame_px_wrong"]["value"] > 0

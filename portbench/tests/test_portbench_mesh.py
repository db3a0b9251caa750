"""A cell whose configuration names a (dp, gop) mesh, run whole at a tiny
size on the CPU, its four slots all on the CPU: `correct` with nothing
broken, and not `correct` under each fault such a cell can have: the
three of a one-card cell in the scan step of every slot, and the
exchange between cards left out (one slot's rows never reach the
gather).  Besides: the mesh's errors, and a configuration without a mesh
builds none."""

from __future__ import annotations

import json
import os
import shutil
import time

import pytest
import torch

from portbench.harness import make_cell_mesh, run_cell
from portbench.spec import Bench

from test_portbench_faults import _broken

CELL = "sp_terminal_dp4"
MESH = {"dp": 4, "gop": 1}


def add_mesh_cell(co: str, chips: int) -> None:
    """Append to checkout `co` the tiny sp4 configuration on a dp=4 mesh
    and a cell of it over cell 1's mix on `chips` cards."""
    root = os.path.join(co, "portbench")
    with open(os.path.join(root, "configs", "sp4_1080p24_b4.json")) as f:
        c = json.load(f)
    c.update(name="sp4_dp4", streams=4, mesh=MESH)
    with open(os.path.join(root, "configs", "sp4_dp4.json"), "w") as f:
        json.dump(c, f)
    with open(os.path.join(co, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["configs"].append({"name": "sp4_dp4", "source": "a test",
                            "file": "portbench/configs/sp4_dp4.json",
                            "reduced": [], "why": "a test configuration"})
    spec["workloads"].append({"name": CELL, "config": "sp4_dp4",
                              "traffic": "terminal_kmv_elided",
                              "chips": chips, "why": "a test cell"})
    with open(os.path.join(co, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)


@pytest.fixture(scope="module")
def mesh_checkout(tiny_checkout, tmp_path_factory):
    co = str(tmp_path_factory.mktemp("mesh") / "co")
    shutil.copytree(tiny_checkout, co)
    add_mesh_cell(co, chips=4)
    return co


def _dropped(raw):
    """run_bg with slot (1, 0)'s result left out of the gather: its part
    of the output holds that slot's carry-in frames instead."""
    from jsplayer_tpu_torch.pipeline.mesh import bg_slots

    def call(mesh, fn, *arrays):
        out = raw(mesh, fn, *arrays)
        frames = out[0] if isinstance(out, tuple) else out
        B, G = max(a.shape[0] for a in arrays), arrays[0].shape[1]
        rows, cols = bg_slots(mesh, B, G)[(1, 0)]
        part = frames[rows, cols]
        part.copy_(arrays[0][rows, cols].to(part.device).unsqueeze(2)
                   .expand_as(part))
        return out

    return call


@pytest.mark.parametrize("fault", [None, "state_unchanged", "half_batch",
                                   "answer_altered", "exchange_dropped"])
def test_mesh_fault_is_caught(mesh_checkout, monkeypatch, fault):
    from jsplayer_tpu_torch.kernels import sp_recon
    from jsplayer_tpu_torch.pipeline import batch, mesh

    shapes = []
    raw_bg, raw_make = batch.run_bg, mesh.make_mesh

    def seen_bg(m, fn, *arrays):
        shapes.append(m.shape)
        return raw_bg(m, fn, *arrays)

    made = []

    def make(*a, **kw):
        made.append(raw_make(*a, **kw))
        return made[-1]

    monkeypatch.setattr(mesh, "make_mesh", make)
    monkeypatch.setattr(batch, "run_bg", seen_bg)
    if fault == "exchange_dropped":
        monkeypatch.setattr(batch, "run_bg", _dropped(seen_bg))
    elif fault is not None:
        monkeypatch.setattr(sp_recon, "kmv_compose",
                            _broken(fault, sp_recon.kmv_compose, True))
    cell = Bench(mesh_checkout).cell(CELL)
    with torch.no_grad():
        res = run_cell(cell, 5, 0.3, False, "cpu", time.perf_counter())
    # one mesh a run, four CPU slots, and every scan went through it
    assert len(made) == 1 and made[0].shape == MESH
    assert {d.type for d in made[0].devices.flat} == {"cpu"}
    assert shapes and all(s == MESH for s in shapes)
    assert res["device"]["count"] == 4
    assert res["correct"] is (fault is None), res["checks"]
    if fault is not None:
        assert res["checks"]["frame_px_wrong"]["value"] > 0


def test_no_mesh_builds_none(tiny_checkout, monkeypatch):
    """A configuration without "mesh" never calls make_mesh and never
    runs a sharded step."""
    from jsplayer_tpu_torch.pipeline import batch, mesh

    def never(*a, **kw):
        raise AssertionError("make_mesh called for a cell without a mesh")

    monkeypatch.setattr(mesh, "make_mesh", never)
    monkeypatch.setattr(batch, "run_bg", never)
    cell = Bench(tiny_checkout).cell("sp1080_terminal_kmv_elided")
    assert "mesh" not in cell.config
    with torch.no_grad():
        res = run_cell(cell, 5, 0.2, False, "cpu", time.perf_counter())
    assert res["correct"], res["checks"]
    assert res["device"]["memory_peak_bytes_by_card"] == [0]


@pytest.mark.parametrize("mesh_cfg,streams,message", [
    ({"dp": 3, "gop": 1}, 3, "dp\\*gop = 3 slots do not divide over its 4"),
    ({"dp": 2, "gop": 1}, 4, "dp\\*gop = 2 slots do not divide over its 4"),
    ({"dp": 8, "gop": 1}, 4, "4 streams do not divide over the mesh's dp"),
])
def test_mesh_errors(mesh_checkout, mesh_cfg, streams, message):
    """dp*gop has to be a multiple of the cell's cards, and the streams a
    multiple of dp."""
    cell = Bench(mesh_checkout).cell(CELL)
    cell.config.update(mesh=mesh_cfg, streams=streams)
    with pytest.raises(ValueError, match=message):
        make_cell_mesh(cell, [torch.device("cpu")] * 4)


@pytest.mark.parametrize("mesh_cfg", [{"dp": 4, "gop": 1},
                                      {"dp": 4, "gop": 2}])
def test_slot_s_on_card_s_mod_chips(mesh_checkout, mesh_cfg):
    """Slot s, process-major, goes on card s % chips (the devices are
    only named here: no card is touched)."""
    cell = Bench(mesh_checkout).cell(CELL)
    cell.config["mesh"] = mesh_cfg
    cards = [torch.device("cuda", k) for k in range(4)]
    m = make_cell_mesh(cell, cards)
    assert m.shape == mesh_cfg
    assert [d.index for d in m.devices.reshape(-1)] == [
        s % 4 for s in range(mesh_cfg["dp"] * mesh_cfg["gop"])]
    assert m.device == cards[0]  # where the port's steps gather


def test_run_needs_the_cells_cards(mesh_checkout, capsys):
    """run.py prints no result and exits non-zero without the cell's
    cards counted up from --device, or with a --device that is no card."""
    from portbench import run

    cell = Bench(mesh_checkout).cell(CELL)
    seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if seen < 5:
        assert "needs 4 CUDA card(s) from cuda:1" in run.missing_cards(
            cell, "cuda:1")
    assert run.missing_cards(cell, "cpu") is None  # the tests' CPU
    for device in (f"cuda:{seen}", "cpu"):
        assert run.main(["--workload", "sp1080_terminal_kmv_elided",
                         "--seed", "1", "--seconds", "1",
                         "--device", device]) == 2
        out = capsys.readouterr()
        assert out.out == "" and "portbench: " in out.err

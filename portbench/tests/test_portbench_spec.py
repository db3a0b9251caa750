"""BENCHMARK.json's form and limits, and discovery by name: each
configuration, mix, span list, counter list and metric reader is found
by its name, and new files plus an entry alone add a cell."""

from __future__ import annotations

import json
import os
import re

import pytest

from portbench.spec import CHECKOUT, Bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = Bench(CHECKOUT).spec
WORKLOADS = [w["name"] for w in SPEC["workloads"]]


def test_form():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert SPEC["paths"] == ["portbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [c["name"] for c in SPEC["configs"]] + WORKLOADS + [
        m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/configs/")
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(
        1, len(WORKLOADS) // 4)
    for c in SPEC["configs"]:
        with open(os.path.join(CHECKOUT, c["file"])) as f:
            mesh = json.load(f).get("mesh")
        chips = {w["chips"] for w in SPEC["workloads"]
                 if w["config"] == c["name"]}
        if mesh is None:  # one card, no mesh
            assert chips == {1}, c["name"]
        else:  # a slot a card
            assert set(mesh) == {"dp", "gop"}, c["name"]
            assert chips == {mesh["dp"] * mesh["gop"]}, c["name"]
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert e2e == {"delivered_fps", "host_cpu_ms_per_frame", "setup_s"}
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert set(m["workloads"]) <= set(WORKLOADS)
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_files_found_by_name(workload):
    bench = Bench(CHECKOUT)
    cell = bench.cell(workload)
    assert cell.config["name"] == next(
        w["config"] for w in SPEC["workloads"] if w["name"] == workload)
    assert os.path.exists(bench.path("recipes", cell.traffic["recipe"],
                                     ".py"))
    assert callable(bench.module("references",
                                 cell.config["reference"]).model)
    fields = cell.ingest_fields()
    from jsplayer_tpu_torch.pipeline.ingest import IngestConfig

    IngestConfig(**fields, device="cpu")  # every field is the port's
    reported = bench.metrics(workload, "per_layer")
    assert reported, "every cell reports a per-layer metric"
    for m in reported:
        reader = bench.module("metrics", m["name"])
        for s in reader.SPANS:
            assert bench.data("spans", s)["names"]
        for s in reader.COUNTERS:
            assert bench.data("counters", s)["names"]


def test_new_files_alone_add_a_cell(tiny_checkout, tmp_path):
    """A new mix (data file), a new recipe and a new metric, with their
    entries: the harness runs the new cell and reports the new metric,
    with no file of the harness edited."""
    import shutil
    import time

    from portbench.harness import run_cell

    co = str(tmp_path / "co")
    shutil.copytree(tiny_checkout, co)
    root = os.path.join(co, "portbench")
    with open(os.path.join(root, "traffic", "terminal_kmv_elided.json")) as f:
        t = json.load(f)
    t.update(recipe="terminal_session_b", pool_seeds=[7, 8])
    with open(os.path.join(root, "traffic", "terminal_b.json"), "w") as f:
        json.dump(t, f)
    shutil.copy(os.path.join(root, "recipes", "terminal_session.py"),
                os.path.join(root, "recipes", "terminal_session_b.py"))
    with open(os.path.join(root, "metrics", "windows_per_s.py"), "w") as f:
        f.write("SPANS = []\nCOUNTERS = []\n\n\ndef read(ctx):\n"
                "    return ctx.frames / ctx.window_s\n")
    with open(os.path.join(co, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["workloads"].append({"name": "sp_terminal_b", "config":
                              "sp4_1080p24_b4", "traffic": "terminal_b",
                              "chips": 1, "why": "a test cell"})
    spec["per_layer"].append({"name": "windows_per_s", "unit": "1/s",
                              "better": "higher", "source": "host_clock",
                              "layer": "test", "moves": "delivered_fps",
                              "workloads": ["sp_terminal_b"]})
    with open(os.path.join(co, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    bench = Bench(co)
    cell = bench.cell("sp_terminal_b")
    res = run_cell(cell, 3, 0.2, True, "cpu", time.perf_counter())
    assert res["correct"], res["checks"]
    assert res["metrics"]["windows_per_s"] > 0
    assert {m["name"] for m in bench.metrics("sp_terminal_b", "per_layer")} \
        == {"windows_per_s"}

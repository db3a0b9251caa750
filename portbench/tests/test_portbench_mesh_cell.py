"""The four-card cell sp1080_terminal_kmv_elided_dp4: its configuration is
cell 1's on a dp=4 mesh, its traced run at the tiny size on four CPU slots
is `correct` and reads every metric the cell reports, and the mesh's
per-layer metrics read what the port's mesh spans and counts."""

from __future__ import annotations

import time

import pytest
import torch

from portbench.harness import Context, run_cell
from portbench.spec import CHECKOUT, Bench

from test_portbench_metrics import FakeProf, ev

CELL = "sp1080_terminal_kmv_elided_dp4"
NEW = ["mesh.shard_ms_per_frame", "mesh.gather_ms_per_frame",
       "mesh.exchange_bytes_per_frame", "mesh.card_idle_max",
       "mesh.compact_ms_per_frame", "upload.pinned_share",
       "upload.wait_ms_per_frame"]
# on the CPU nothing is pinned (the share reads 0) and no refill waits on a
# card's event, so upload.wait_ms_per_frame finds nothing to read there
TRACED_ON_CPU = set(NEW) - {"upload.wait_ms_per_frame"}


def test_the_configuration_is_cell_1s_on_a_mesh():
    """Every key of the one-card configuration holds its value, but the
    name, the stream count and what describes the deployment; the mesh
    is dp=4, gop=1, a slot a card."""
    bench = Bench(CHECKOUT)
    one = bench.cell("sp1080_terminal_kmv_elided")
    four = bench.cell(CELL)
    assert four.chips == 4 and four.traffic == one.traffic
    assert four.config["mesh"] == {"dp": 4, "gop": 1}
    assert four.config["streams"] == 16 and four.config["reduced"] == []
    told = {"name", "streams", "mesh", "deployment", "source", "assumed",
            "why"}
    assert set(four.config) - told == set(one.config) - told
    for k in set(one.config) - told:
        assert four.config[k] == one.config[k], k
    assert [m["name"] for m in bench.metrics(CELL, "per_layer")] == NEW


def test_traced_cell_on_four_cpu_slots(tiny_checkout):
    """The real configuration at the tiny size, traced: `correct`, every
    metric reads a number, and the counts are the mesh's: a dispatch a
    window, four slots a dispatch, the carry and three slots' rows crossing
    every dispatch."""
    from jsplayer_tpu_torch.utils.logging import TRACE

    cell = Bench(tiny_checkout).cell(CELL)
    with torch.no_grad():
        res = run_cell(cell, 2**31 + 77, 0.3, True, "cpu",
                       time.perf_counter())
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == TRACED_ON_CPU
    assert res["metrics"]["upload.pinned_share"] == 0.0
    assert all(v >= 0 for v in res["metrics"].values()), res["metrics"]
    s = TRACE.summary()
    c = s["counters"]
    assert c["mesh.dispatches"] == s["calls"]["jsp.shard"] == \
        s["calls"]["jsp.gather"]
    assert c["mesh.slot_launches"] == 4 * c["mesh.dispatches"]
    assert 0 < c["mesh.dispatches"] <= res["window"]["windows"]
    # each dispatch: three slots' carries in, their rows out, 4 B a pixel
    px = cell.config["width"] * cell.config["height"] * 4
    rows = c["frames.scanned"]
    assert c["mesh.exchange_bytes"] == 3 * px * (
        4 * c["mesh.dispatches"] + rows // 4)
    assert res["metrics"]["mesh.exchange_bytes_per_frame"] == \
        pytest.approx(c["mesh.exchange_bytes"] / res["window"]["frames"])
    # no card on the CPU: the idlest of the four idle throughout
    assert res["metrics"]["mesh.card_idle_max"] == 100.0


def test_card_idle_max_reads_card_busy_seconds():
    """The idlest card of four by a synthetic trace of the window
    (1000-11000 us): card 0 busy 3000 us, card 1 busy 1000 us, cards 2
    and 3 in between; then one of the four cards missing from the trace
    reads 100%."""
    from portbench.trace import read_trace

    bench = Bench(CHECKOUT)
    win = ev("user_annotation", "portbench.window", 1000.0, 10000.0)
    busy = [ev("kernel", "kmv_compose", 2000.0, 3000.0, card=0),
            ev("gpu_memcpy", "Memcpy PtoP (Device -> Device)", 5000.0,
               1000.0, card=1),
            ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 3000.0,
               2000.0, card=2),
            ev("kernel", "kmv_compose", 4000.0, 1500.0, card=3)]
    c = Context(cell=bench.cell(CELL), trace=read_trace(FakeProf(
        [win] + busy)), frames=10, window_s=0.01)
    assert c.card_busy_seconds() == pytest.approx(
        {0: 3e-3, 1: 1e-3, 2: 2e-3, 3: 1.5e-3})
    reader = bench.module("metrics", "mesh.card_idle_max")
    assert reader.read(c) == pytest.approx(100 * (1 - 1000 / 10000))
    c.trace = read_trace(FakeProf([win] + busy[:1] + busy[2:]))
    assert reader.read(c) == 100.0

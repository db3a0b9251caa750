"""The cell msv1_qvga8_mp3_desktop (BASELINE config 2: MSVideo1 8-bit
palettized with an MP3 track) as BENCHMARK.json names it: its files found
by name, its inputs byte for byte at the tiny size, a whole run on the CPU
`correct` with no audio frame wrong, the control failing on frames and on
audio, and its two metrics of the MP3 demux (jsp.audio's self time a
delivered frame and an MP3 frame) read on a traced run, and left out on a
port whose demux opens no jsp.audio span."""

from __future__ import annotations

import hashlib
import json
import time

import numpy as np
import pytest
import torch

from portbench.harness import Context, run_cell
from portbench.spec import CHECKOUT, Bench

CELL = "msv1_qvga8_mp3_desktop"
METRICS = ("audio.self_ms_per_frame", "audio.us_per_mp3_frame")
SEED = 2**31 + 99
# at the tiny size and SEED: the pool stream of each slot, and for pool
# stream p the SHA-256 of its container, of its source frames [T, Y, X]
# u32 and of its track's MP3 frames
FROZEN = (
    [0, 1, 2, 0, 3, 1, 2, 3],
    ["1a7b85ec6a70dbb8e8ddc2b93a5b7cdcaa0b033fa6f64e7d9e5efe664a8568ac",
     "f38d2b5d5a0a31c795ef9a1c73b2f1d296654bf097c991b24b5666895595392c",
     "0c201b4d366339cfe0e4eccf76f710004bef024cb9f50078c85c48db70ce6bea",
     "260c4e3a9443de260b0ba80c5f6206642dae4458004533a78f3f9b1e210b118f"],
    ["c806c72a2e910c98bc0deab6b78480caf45790655022eedc0bbb90ef49a4ed94",
     "fd268dcc4ba8ea3271875ef15322f57864ea8869e954a66941fed02acfcf5101",
     "510f8dd5ccaf82725f80c61a29eae4c423f09a7ae689feec96ad4f5999fac1d5",
     "af72cd03547c1403b0d7a025ebb45f431ed1006dee6636b44d870a4fa59af76f"],
    ["0eb78e0fb3bf79f62e38f7a98c6bccfdf2c1bf65f3d368e4f67844c3ff54f8fc",
     "9822298a52497bf07e35b665462a76bdd2bdb39190ffcfb2436aed33865ace2e",
     "a09b1f88b8ecc350a9cc248edc5263eb011299f6d0e3e2296548e3781a9a8c79",
     "acb7dc487063c483dfd0b0b4f6e75eb11da53a35b920234589302f7923dfd2f1"])


def _sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def test_cell_files_are_found_by_name():
    bench = Bench(CHECKOUT)
    cell = bench.cell(CELL)
    w = next(w for w in bench.spec["workloads"] if w["name"] == CELL)
    assert (w["config"], w["traffic"], w["chips"]) == (
        "msv1_qvga8_mp3_b8", "msv1_desktop_8", 1)
    assert cell.config["name"] == "msv1_qvga8_mp3_b8"
    assert (cell.config["codec"], cell.config["bpp"]) == ("msv1_8", 8)
    assert cell.config["audio"] == {"format": "mp3", "bitrate_kbps": 128,
                                    "sample_rate": 44100, "channels": 2}
    assert "mesh" not in cell.config
    ref = bench.module("references", cell.config["reference"])
    assert ref.LIMITS == {"frame_px_wrong": 0, "model_elems_wrong": 0,
                          "audio_frames_wrong": 0}
    # the 16-bit cell's ingest and mix, with 8-bit indices
    other = bench.cell("msv1_qvga16_desktop")
    assert cell.config["ingest"] == other.config["ingest"]
    assert cell.traffic == dict(other.traffic, recipe_params={"bits": 8})
    reported = {m["name"]: m for m in bench.metrics(CELL, "per_layer")}
    assert set(METRICS) <= set(reported)
    # every layer the 16-bit cell reports, this cell reports too
    assert {m["name"] for m in bench.metrics("msv1_qvga16_desktop",
                                             "per_layer")} < set(reported)
    for name in METRICS:
        m = reported[name]
        assert m["workloads"] == [CELL] and m["moves"] == "delivered_fps"
        assert m["layer"] == "pipeline.ingest StreamReader, the MP3 demux"
        assert callable(bench.module("metrics", name).read)


def test_inputs_are_frozen(tiny_checkout):
    from portbench.inputs import make_inputs

    inp = make_inputs(Bench(tiny_checkout).cell(CELL), SEED)
    pool, containers, frames, audio = FROZEN
    assert inp.pool == pool
    assert [_sha(c) for c in inp.containers] == [containers[p] for p in pool]
    assert all(f.dtype == np.uint32 for f in inp.frames)
    assert [_sha(np.ascontiguousarray(f).tobytes()) for f in inp.frames] == \
        [frames[p] for p in pool]
    assert [_sha(b"".join(a)) for a in inp.audio] == [audio[p] for p in pool]


def test_run_is_correct(tiny_checkout):
    cell = Bench(tiny_checkout).cell(CELL)
    with torch.no_grad():
        res = run_cell(cell, 2**31 + 17, 0.3, False, "cpu",
                       time.perf_counter())
    assert res["correct"], res["checks"]
    assert {k: c["value"] for k, c in res["checks"].items()} == {
        "frame_px_wrong": 0, "model_elems_wrong": 0, "audio_frames_wrong": 0}
    assert res["window"]["passes"] >= 1 and res["failed"] == 0


def test_control_fails(tiny_checkout, capsys):
    from portbench import readings

    assert readings.main(["--workload", CELL, "--seconds", "0.1",
                          "--seeds", "6", "--control-seeds", "6",
                          "--device", "cpu", "--checkout",
                          tiny_checkout]) == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert lines[0]["correct"] and not lines[0]["control_correct"]
    ctl = lines[-1]["control_min"]
    assert ctl["frame_px_wrong"] > 0 and ctl["audio_frames_wrong"] > 0


def test_traced_run_reads_the_audio_metrics(tiny_checkout):
    bench = Bench(tiny_checkout)
    with torch.no_grad():
        res = run_cell(bench.cell(CELL), 2**31 + 21, 0.3, True, "cpu",
                       time.perf_counter())
    assert res["correct"], res["checks"]
    for name in METRICS:
        assert res["metrics"][name] > 0, name
    # and the 16-bit cell's: all but kernels_roofline, which reads only
    # the card's kernels
    shared = {m["name"] for m in bench.metrics("msv1_qvga16_desktop",
                                               "per_layer")}
    assert shared - set(res["metrics"]) == {"kernels_roofline"}
    from jsplayer_tpu_torch.utils.logging import TRACE

    s = TRACE.summary()
    assert s["counters"]["audio.frames"] > 0
    assert res["metrics"]["audio.us_per_mp3_frame"] == pytest.approx(
        1e6 * s["self_s"]["jsp.audio"] / s["counters"]["audio.frames"])


def test_a_port_without_the_audio_span_leaves_them_out(tiny_checkout,
                                                       monkeypatch):
    """A demux that parses its tracks in no jsp.audio span and counts
    nothing, as before the span: the traced run reports neither metric,
    and still the layers that do not read the span."""
    from jsplayer_tpu_torch.pipeline import ingest

    monkeypatch.setattr(ingest, "_parse_audio",
                        lambda loader, parse: parse())
    cell = Bench(tiny_checkout).cell(CELL)
    with torch.no_grad():
        res = run_cell(cell, 2**31 + 23, 0.3, True, "cpu",
                       time.perf_counter())
    assert res["correct"], res["checks"]
    assert not set(METRICS) & set(res["metrics"])
    assert res["metrics"]["prep.self_ms_per_frame"] > 0


@pytest.mark.parametrize("name", METRICS)
def test_none_from_a_port_without_the_tracer(monkeypatch, name):
    from jsplayer_tpu_torch.utils import logging

    monkeypatch.delattr(logging, "TRACE")
    bench = Bench(CHECKOUT)
    ctx = Context(cell=bench.cell(CELL), spans=None, launches={},
                  trace=None, frames=200, window_s=1.0, coded_bytes=0,
                  out_bytes=0)
    assert bench.module("metrics", name).read(ctx) is None

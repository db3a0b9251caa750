"""The plain ds2 epilogue matches the port's at a small size, and the
control (the reference one precision below) is not correct."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.judge import Judge, control_windows
from portbench.spec import CHECKOUT, Bench

BENCH = Bench(CHECKOUT)
REF = BENCH.module("references", "ds2_frames")


@pytest.mark.parametrize("config", ["sp4_1080p24_b4", "msv1_qvga16_b8"])
@pytest.mark.parametrize("shape", [(3, 8, 12), (2, 33, 47)])
def test_plain_ds2_is_the_ports(config, shape):
    from jsplayer_tpu_torch.kernels.rgb_convert import to_model_input

    cfg = BENCH.data("configs", config)
    rng = np.random.default_rng(shape[1])
    f = torch.from_numpy(rng.integers(0, 1 << 32, shape, dtype=np.uint64)
                         .astype(np.uint32).view(np.int32))
    want = to_model_input(f, dtype=torch.bfloat16, downscale=2)
    got = REF.model(f, cfg)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("workload", ["sp1080_terminal_kmv_elided",
                                      "msv1_qvga16_desktop"])
def test_control_is_not_correct(tiny_checkout, workload):
    """The control fails both numbers; the exact reference in its place
    passes both."""
    from portbench.inputs import make_inputs

    cell = Bench(tiny_checkout).cell(workload)
    inp = make_inputs(cell, 21)
    T, W = cell.config["frames"], cell.config["ingest"]["window"]
    ctl = Judge(inp.frames, cell.config, REF, "cpu")
    for w in control_windows(inp.frames, cell.config, REF, "cpu", W):
        ctl.window(w, T)
    assert not ctl.correct()
    assert all(c["value"] > 0 for c in ctl.checks().values()), ctl.checks()
    exact = Judge(inp.frames, cell.config, REF, "cpu")
    for w in control_windows(inp.frames, cell.config, REF, "cpu", W):
        src = torch.stack([torch.from_numpy(np.ascontiguousarray(
            f[w["start_frame"]:w["start_frame"] + W].view(np.int32)))
            for f in inp.frames])
        w = dict(w, frames_u32=src,
                 model_input=torch.stack([REF.model(s, cell.config)
                                          for s in src]))
        exact.window(w, T)
    assert exact.correct(), exact.checks()


def test_readings_script(tiny_checkout, capsys):
    """portbench/readings.py: the program's readings are 0 and the
    control's are not, one JSON line a seed and a summary."""
    import json

    from portbench import readings

    assert readings.main(["--workload", "sp1080_terminal_kmv_elided",
                          "--seconds", "0.1", "--seeds", "4", "5",
                          "--control-seeds", "5", "--device", "cpu",
                          "--checkout", tiny_checkout]) == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert [d.get("seed") for d in lines] == [4, 5, None]
    assert all(d["correct"] for d in lines[:2])
    assert lines[-1]["program_max"] == {"frame_px_wrong": 0,
                                        "model_elems_wrong": 0}
    assert min(lines[-1]["control_min"].values()) > 0

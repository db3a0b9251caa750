"""jsplayer_tpu_torch.validate (the port's twin of scripts/tpu_validate.py's
parity legs) on the CPU: its stream and the copied stack_sp_commands
against the JAX package's, every leg true through the plain twins, and
the entry point's JSON line."""

import json

import numpy as np
import pytest
import torch

from jsplayer_tpu.encode.sp_enc import ScreenPressorEncoder, pack_rgb
from jsplayer_tpu.pipeline.batch import stack_sp_commands as j_stack
from jsplayer_tpu_torch import validate as V
from jsplayer_tpu_torch.pipeline.batch import stack_sp_commands as p_stack

torch.set_num_threads(1)


def reference_stream():
    """scripts/tpu_validate.py:30-44 with the JAX package's encoder."""
    X, Y = 256, 128
    enc = ScreenPressorEncoder(4, X, Y)
    rng = np.random.default_rng(0)
    f = np.full((Y, X), pack_rgb(7, 7, 7), dtype=np.uint32).reshape(-1)
    streams, golds = [enc.encode_i(f)], [f]
    for t in range(6):
        nf = f.copy().reshape(Y, X)
        if t % 2 == 0:
            nf[4:, :] = nf[:-4, :].copy()
        else:
            nf[10:30, 40:200] = pack_rgb(*rng.integers(0, 256, 3))
        f = nf.reshape(-1)
        streams.append(enc.encode_p(f))
        golds.append(f)
    return streams, golds


def test_validate_stream_is_the_scripts():
    got, want = V.make_stream(), reference_stream()
    assert got[0] == want[0]
    for g, w in zip(got[1], want[1]):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("native", [True, False])
def test_stack_sp_commands_copy(native, monkeypatch):
    """The copy against the original on both host branches (the native
    thread pool and the pure-Python oracle), over two streams."""
    if not native:
        from jsplayer_tpu import native as j_native
        from jsplayer_tpu_torch import native as p_native

        for mod in (j_native, p_native):
            monkeypatch.setattr(mod, "available", lambda: False)
    streams, _ = reference_stream()
    got = p_stack([streams, streams], 256, 128)
    want = j_stack([streams, streams], 256, 128)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def legs():
    return V.Legs("cpu")


@pytest.mark.parametrize("leg", V.LEGS)
def test_validate_leg_on_the_cpu(legs, leg):
    assert getattr(legs, leg)() is True


def test_validate_entry_point(capsys):
    assert V.main(["--device", "cpu"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res == {leg: True for leg in V.LEGS}

"""The benchmark's frozen input makers give the bytes the port's own makers
give today, at a small size, and the seed draws an order of one pool."""

from __future__ import annotations

import numpy as np
import pytest

from portbench.spec import CHECKOUT, Bench

BENCH = Bench(CHECKOUT)


@pytest.mark.parametrize("seed", [0, 5, 2**31 + 7])
def test_recipes_are_the_ports(seed):
    from jsplayer_tpu_torch.experiments import msv1_step
    from jsplayer_tpu_torch.utils import corpora

    got = BENCH.module("recipes", "terminal_session").frames(seed, 20, 128,
                                                             192)
    assert np.array_equal(got, np.stack(corpora.terminal_session(
        T=20, Y=128, X=192, seed=seed)))
    got = BENCH.module("recipes", "video_call").frames(seed, 5, 128, 192,
                                                       vw=96, vh=48)
    assert np.array_equal(got, np.stack(corpora.video_call(
        T=5, Y=128, X=192, seed=seed, vw=96, vh=48)))
    got = BENCH.module("recipes", "msv1_desktop").frames(seed, 16, 48, 64)
    want, _ = msv1_step._frames(np.random.default_rng(seed), 16, 16, 64, 48)
    assert np.array_equal(got, np.stack(want))


def test_sp_encoder_is_the_ports():
    from jsplayer_tpu_torch import native
    from jsplayer_tpu_torch.encode.avi_mux import mux_avi as port_mux
    from jsplayer_tpu_torch.utils import corpora
    from portbench.encode import sp4
    from portbench.encode.avi_mux import mux_avi

    if not native.available():
        pytest.skip("the port's native library does not build here")
    frames = np.stack(corpora.terminal_session(T=24, Y=128, X=192, seed=3))
    keys = [t in (0, 10) for t in range(24)]
    got = sp4.encode(frames, keys)
    enc = native.NativeScreenPressorEncoder(4, 192, 128)
    want = [enc.encode_i(f.reshape(-1)) if k else enc.encode_p(f.reshape(-1))
            for f, k in zip(frames, keys)]
    assert got == want
    assert mux_avi(got, 192, 128, 24, codec="SPV4", keyflags=keys) == \
        port_mux(want, 192, 128, 24, codec="SPV4", keyflags=keys)


def test_msv1_streams_are_the_ports():
    """Pool stream i is msv1_step's stream i of seed 0."""
    from jsplayer_tpu_torch.experiments.msv1_step import msv1_streams
    from portbench.inputs import _pool_stream
    from portbench.spec import Cell

    cfg = dict(BENCH.cell("msv1_qvga16_desktop").config, width=64,
               height=48, frames=40)
    cell = Cell("t", 1, cfg, BENCH.data("traffic", "msv1_desktop"), BENCH)
    want = msv1_streams(16, 4, 40, 64, 48, seed=0)
    for i in range(4):
        avi, frames, sizes, _ = _pool_stream(cell, i)
        assert avi == want["avis"][i]
        assert np.array_equal(frames[:16].reshape(16, -1),
                              np.stack(want["frames"][i]))
        assert np.array_equal(frames[16:32], frames[:16])
        assert list(sizes) == [len(c) for c in want["chunks"][i]]


def test_seed_draws_an_order_of_one_pool(tiny_checkout):
    from portbench.inputs import make_inputs

    cell = Bench(tiny_checkout).cell("sp1080_terminal_kmv_elided")
    a, b, a2 = (make_inputs(cell, s) for s in (11, 12, 11))
    assert a.containers == a2.containers and a.pool == a2.pool
    assert a.pool != b.pool
    # the same distinct streams, in another order
    assert sorted(a.pool) == sorted(b.pool) == [0, 1, 2, 3]
    assert sorted(a.containers) == sorted(b.containers)
    T = cell.config["frames"]
    recipe = BENCH.module("recipes", "terminal_session")
    for inp in (a, b):
        for f, p in zip(inp.frames, inp.pool):
            src = recipe.frames(cell.traffic["pool_seeds"][p], T,
                                *f.shape[1:])
            assert np.array_equal(f, src)

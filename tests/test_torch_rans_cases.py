"""The inputs the rANS tests share: tests/test_rans_lanes.py's symbol
distributions, the frequency tables the container admits (and the
ingest's pad row), random u32 states.  Both sides draw from them:
tests/test_torch_rans_lanes.py (the plain twins against the JAX package on
the CPU) and tests/test_torch_cuda.py (the kernels against the twins on the
card).  numpy and torch only: the card side runs where jax is absent."""

import zlib

import numpy as np
import pytest
import torch

from jsplayer_tpu_torch.kernels.rans_lanes import PROB_SCALE, build_freq_table

DISTS = ["uniform", "skewed", "peaked"]


def symbols(dist, n, seed):
    """tests/test_rans_lanes.py's three symbol distributions."""
    rng = np.random.default_rng(seed)
    if dist == "uniform":
        return rng.integers(0, 256, n).astype(np.uint8)
    if dist == "skewed":
        return (rng.gamma(1.0, 20.0, n).astype(np.int64) % 256).astype(
            np.uint8)
    return rng.choice([0, 0, 0, 0, 7, 7, 255], n).astype(np.uint8)


def seed_of(*parts) -> int:
    return zlib.crc32(repr(parts).encode())


def u32_states(rng, n):
    """Random u32 states with 0, 2^31, 2^32 - 1 and values >= 2^31 among
    them."""
    st = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    st[:3] = [0, 2**31, 2**32 - 1][:n]
    return st


def tables(dist):
    """The uniform, skewed and peaked tables of the grid, and the ingest's
    pad row (freq[0] = 3841, every other entry 1)."""
    if dist == "pad":
        f = np.ones(256, np.int32)
        f[0] += PROB_SCALE - 256
        return f
    return build_freq_table(symbols(dist, 4000, seed_of("table", dist)))


def i32(a):
    """u32 numpy words → their int32 bit-view tensor."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


@pytest.mark.parametrize("dist", DISTS + ["pad"])
def test_tables_are_what_the_container_admits(dist):
    """Every table is positive and sums to PROB_SCALE (lane_format's test);
    the pad row is freq[0] = 3841, the rest 1."""
    f = tables(dist)
    assert f.dtype == np.int32 and f.shape == (256,)
    assert int(f.sum()) == PROB_SCALE and (f > 0).all()
    if dist == "pad":
        assert f[0] == 3841 and (f[1:] == 1).all()


def test_u32_states_hold_the_corners():
    st = u32_states(np.random.default_rng(0), 64)
    assert st.dtype == np.uint32
    assert {0, 2**31, 2**32 - 1} <= set(st.tolist())
    assert (st >= 2**31).sum() > 10

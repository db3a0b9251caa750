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


#: csrc/rans_lanes.cu's stage depth (kStage) and ring (kRing chunks of 16
#: bytes a lane): the cases step around them
STAGE = 32
RING_BYTES = 16 * 16

#: name -> (B, N, steps, L, refills' byte offset in their buffer,
#: lane_bytes' byte offset, bytes between stream rows past N * L, the
#: aligned decode's instance).  The staged instance takes refills with a
#: 16-byte aligned start and batch stride and N % 8 == 0; any other shape
#: the byte-load instance.  Steps at STAGE - 1, STAGE, STAGE + 1 and
#: 2 STAGE + 1; N in {1, 127, 129, 4096} and a partial last block that
#: stages (136); L in {0, 1, 15, 16, 17} and rows longer than the ring
#: whose last fill crosses the row's end; offset views of both inputs.
RANS_CASES = {
    "steps_stage_minus_1": (2, 256, STAGE - 1, 9, 0, 0, 0, "staged"),
    "steps_stage": (2, 256, STAGE, 9, 0, 0, 0, "staged"),
    "steps_stage_plus_1": (2, 256, STAGE + 1, 9, 0, 0, 0, "staged"),
    "steps_2stage_plus_1": (3, 256, 2 * STAGE + 1, 40, 0, 0, 0, "staged"),
    "n1": (2, 1, 40, 17, 0, 0, 0, "bytes"),
    "n127": (2, 127, 40, 15, 0, 0, 0, "bytes"),
    "n129": (2, 129, 70, 16, 0, 0, 0, "bytes"),
    "n136_partial_block": (2, 136, 70, 33, 0, 0, 0, "staged"),
    "n4096": (4, 4096, 70, 60, 0, 0, 0, "staged"),
    "l0": (2, 64, 40, 0, 0, 0, 0, "staged"),
    "l1": (2, 64, 40, 1, 0, 0, 0, "staged"),
    "l15": (2, 64, 40, 15, 0, 0, 0, "staged"),
    "l16": (2, 64, 40, 16, 0, 0, 0, "staged"),
    "l17": (2, 64, 40, 17, 0, 0, 0, "staged"),
    "rows_past_the_ring": (2, 200, 900, RING_BYTES + 745, 0, 0, 0,
                           "staged"),
    "rows_past_the_ring_odd": (3, 40, 1300, 3 * RING_BYTES + 3, 0, 0, 0,
                               "staged"),
    "refills_odd_address_n_odd": (2, 97, 45, 5, 1, 0, 0, "bytes"),
    "refills_offset_8": (2, 96, 45, 5, 8, 0, 0, "bytes"),
    "refills_offset_16": (2, 96, 45, 5, 16, 0, 0, "staged"),
    "lane_bytes_offset_1": (2, 96, 60, 13, 0, 1, 0, "staged"),
    "lane_bytes_offset_7_padded_rows": (3, 56, 300, 129, 0, 7, 11, "staged"),
}


def rans_case_inputs(case):
    """RANS_CASES[case]'s inputs on the CPU: (refills [B, steps, N, 2],
    lane_bytes [B, N, L], states [B, N] int32, freq [B, 256]), random u32
    states (0 and >= 2^31 among them), random refills and lane bytes (the
    lanes of the longer cases read past their rows' ends), a table a stream
    from the skewed, peaked, pad and uniform set."""
    B, N, steps, L = RANS_CASES[case][:4]
    rng = np.random.default_rng(seed_of("rans_case", case))
    dists = ("skewed", "peaked", "pad", "uniform")
    freq = np.stack([tables(dists[b % 4]) for b in range(B)])
    states = np.stack([u32_states(rng, N) for _ in range(B)])
    refills = rng.integers(0, 256, (B, steps, N, 2), dtype=np.uint8)
    lanes = rng.integers(0, 256, (B, N, L), dtype=np.uint8)
    return (torch.from_numpy(refills), torch.from_numpy(lanes), i32(states),
            torch.from_numpy(freq))


def offset_view(t: torch.Tensor, offset: int, pad: int = 0,
                device=None) -> torch.Tensor:
    """t's values in a fresh uint8 buffer on `device`, starting `offset`
    bytes into it, with `pad` bytes between streams (dim 0) → the view."""
    stride = list(t.stride())
    stride[0] += pad
    buf = torch.full((offset + t.shape[0] * stride[0] + 16,), 0xA5,
                     dtype=torch.uint8, device=device)
    view = torch.as_strided(buf, t.shape, stride, offset)
    view.copy_(t.to(device))
    return view


@pytest.mark.parametrize("case", sorted(RANS_CASES))
def test_rans_cases_are_well_formed(case):
    """Each case's inputs have their shapes, and its offset views hold the
    values at the stated offsets and strides (what the card tests rely on)."""
    B, N, steps, L, rf_off, ln_off, pad, instance = RANS_CASES[case]
    refills, lanes, states, freq = rans_case_inputs(case)
    assert refills.shape == (B, steps, N, 2) and lanes.shape == (B, N, L)
    assert states.shape == (B, N) and freq.shape == (B, 256)
    view = offset_view(refills, rf_off)
    assert torch.equal(view, refills)
    assert view.storage_offset() == rf_off
    lv = offset_view(lanes, ln_off, pad)
    assert torch.equal(lv, lanes) and lv.stride(0) == N * L + pad
    staged = rf_off % 16 == 0 and N % 8 == 0
    assert instance == ("staged" if staged else "bytes")


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

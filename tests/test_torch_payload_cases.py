"""PAYLOAD_CASES: the case table of csrc/sparse_payload.cu (the port's
unpack_payload), shared by tests/test_torch_sparse_payload.py (the port's
plain twin against jsplayer_tpu.kernels.sparse_payload on the CPU) and
tests/test_torch_cuda.py (the kernel against the twin on the card).

Each case is the reference's one-hot product at an edge the scatter must
reproduce: words that round through f32 and saturate, tiles that name one
block twice or more (summed in f32), indices outside [0, NB), no tiles.
Three or more tiles on one block keep every partial sum below 2^24, where
f32 sums are exact in any order; two tiles on one block take any words,
since a + b == b + a in f32.  numpy only: the card's machine has no jax."""

import numpy as np

Y, X = 32, 64
NB = (Y // 16) * (X // 16)


def _words(rng, shape, lo=0, hi=1 << 32):
    return rng.integers(lo, hi, shape, dtype=np.uint64).astype(np.uint32)


def _case_packed(rng):
    """pack_tiles' own shape: distinct blocks, -1 pads."""
    tb = np.full(8, -1, np.int32)
    tb[:5] = rng.choice(NB, 5, replace=False)
    return _words(rng, (8, 256), hi=1 << 24), tb


def _case_repeat2(rng):
    """Pairs of tiles on one block, words anywhere in [0, 2^32)."""
    tb = np.array([3, 0, 3, 5, 0, 7, -1, 7], np.int32)
    return _words(rng, (8, 256)), tb


def _case_repeat3(rng):
    """Three and four tiles on one block, partial sums below 2^24."""
    tb = np.array([2, 2, 6, 2, 6, 6, 6, 1], np.int32)
    return _words(rng, (8, 256), hi=1 << 22), tb


def _case_f32_rounding(rng):
    """2^24 + 1 and 5 on block 0 give 16777220, as the one-hot product
    does; 0xFFFFFFFF saturates; words at and above 2^24 round to even."""
    tiles = _words(rng, (4, 256), lo=1 << 24)
    tiles[0, :] = (1 << 24) + 1
    tiles[1, :] = 5
    tiles[2, :8] = 0xFFFFFFFF
    tiles[2, 8:16] = (1 << 24) + 3
    tiles[3, :4] = [0xFFFFFF7F, 0xFFFFFF80, 0xFFFFFF81, 0x80000001]
    return tiles, np.array([0, 0, 4, 7], np.int32)


def _case_out_of_range(rng):
    """Indices at and past NB, and below -1, name no block."""
    tb = np.array([NB, -2, 1, NB + 100, -(1 << 31), (1 << 31) - 1, 6, -1],
                  np.int32)
    return _words(rng, (8, 256)), tb


def _case_no_tiles(rng):
    """M = 0: every word is 0."""
    return np.zeros((0, 256), np.uint32), np.zeros(0, np.int32)


def _case_all_pads(rng):
    return _words(rng, (5, 256)), np.full(5, -1, np.int32)


PAYLOAD_CASES = {
    "packed": _case_packed,
    "repeat2": _case_repeat2,
    "repeat3": _case_repeat3,
    "f32_rounding": _case_f32_rounding,
    "out_of_range": _case_out_of_range,
    "no_tiles": _case_no_tiles,
    "all_pads": _case_all_pads,
}


def case_inputs(name, seed=0):
    """(tiles [M, 256] u32, tile_block [M] i32) of one case."""
    return PAYLOAD_CASES[name](np.random.default_rng(seed))


def window_inputs(T, M, seed, nb=NB, repeats=True):
    """A window of T frames: tiles [T, M, 256] u32, tile_block [T, M] i32
    with pads, out-of-range indices and (with `repeats`) pairs of tiles on
    one block."""
    rng = np.random.default_rng(seed)
    tiles = _words(rng, (T, M, 256))
    tb = np.stack([rng.permutation(nb + M)[:M] for _ in range(T)]) \
        .astype(np.int32)  # values >= nb name no block
    tb[:, ::5] = -1
    if repeats and M >= 4:
        tb[:, 1] = tb[:, 3]
    return tiles, tb

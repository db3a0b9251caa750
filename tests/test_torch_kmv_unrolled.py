"""The port's unrolled compact kmv scan (jsplayer_tpu_torch.kernels.sp_recon
decode_sequence_kmv_compact_unrolled over kmv_compose_frames, plain twins
on the CPU) against jsplayer_tpu's, bit for bit, on the inputs of
tests/test_transcode_kmv.py's parity test: U in {1, 2, 4}, an all-copy pad
plane mid-stream, negative and wrapping motion vectors, and the
AssertionError both raise when U does not divide T."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jsplayer_tpu.kernels import sp_recon as J
from jsplayer_tpu_torch.kernels import sp_recon as P

torch.set_num_threads(1)


def t32(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def unrolled_inputs(seed=3, Y=32, X=64, T=8, K=2, mv_range=(-4, 5)):
    """tests/test_transcode_kmv.py's inputs: init, paycode [T, Y, X] with
    data, copy and motion pixels (frame 5 all-copy), mvk [T, K, 2]."""
    rng = np.random.default_rng(seed)
    init = rng.integers(0, 1 << 24, (Y, X)).astype(np.uint32)
    ptype = rng.choice([0, 1, 2], (T, Y, X), p=[0.5, 0.3, 0.2]).astype(
        np.uint32)
    kslot = rng.integers(0, K, (T, Y, X)).astype(np.uint32)
    pix = rng.integers(0, 1 << 24, (T, Y, X)).astype(np.uint32)
    pc = (np.where(ptype == 1, pix, 0) | (ptype << 24)
          | np.where(ptype == 2, kslot << 26, 0))
    pc[min(5, T - 1)] = 0  # an all-copy (pad-style) plane mid-stream
    mvk = rng.integers(*mv_range, (T, K, 2)).astype(np.int32)
    return init, pc.astype(np.uint32), mvk


@pytest.mark.parametrize("unroll", [1, 2, 4])
@pytest.mark.parametrize("mv_range", [(-4, 5), (-200, 200)],
                         ids=["small", "wrapping"])
def test_unrolled_matches_reference(unroll, mv_range):
    init, pc, mvk = unrolled_inputs(mv_range=mv_range)
    want = np.asarray(J.decode_sequence_kmv_compact_unrolled(
        jnp.asarray(init), jnp.asarray(pc), jnp.asarray(mvk), unroll=unroll))
    got = P.decode_sequence_kmv_compact_unrolled(t32(init), t32(pc),
                                                 torch.from_numpy(mvk),
                                                 unroll=unroll)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    flat = P.decode_sequence_kmv_compact(t32(init), t32(pc),
                                         torch.from_numpy(mvk))
    assert torch.equal(got, flat)


@pytest.mark.parametrize("T,unroll", [(8, 3), (6, 4), (5, 2)])
def test_unroll_that_does_not_divide_t_raises_in_both(T, unroll):
    init, pc, mvk = unrolled_inputs(T=T)
    with pytest.raises(AssertionError):
        J.decode_sequence_kmv_compact_unrolled(
            jnp.asarray(init), jnp.asarray(pc), jnp.asarray(mvk),
            unroll=unroll)
    with pytest.raises(AssertionError):
        P.decode_sequence_kmv_compact_unrolled(
            t32(init), t32(pc), torch.from_numpy(mvk), unroll=unroll)


@pytest.mark.parametrize("U,K", [(1, 1), (3, 2), (4, 8)])
def test_kmv_compose_frames_chains_the_single_frame_compose(U, K):
    """kmv_compose_frames' CPU branch: frame u is the reference's
    compose_frame_kmv of frame u-1, written into `out` when given."""
    init, pc, mvk = unrolled_inputs(seed=U + K, T=U, K=K,
                                    mv_range=(-70, 70))
    out = torch.full((U, 32, 64), 7, dtype=torch.int32)
    got = P.kmv_compose_frames(t32(init), t32(pc), torch.from_numpy(mvk),
                               out=out)
    assert got is out
    cur = jnp.asarray(init)
    for u in range(U):
        cur = J.compose_frame_kmv(cur, jnp.asarray(pc[u]),
                                  jnp.asarray(mvk[u]))
        np.testing.assert_array_equal(got[u].numpy().view(np.uint32),
                                      np.asarray(cur))
    assert P.kmv_compose_frames.launches == 0

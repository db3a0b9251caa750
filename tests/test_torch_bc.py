"""The port's bc transport (jsplayer_tpu_torch.kernels.sp_recon) against the
JAX package's, bit for bit, on the CPU: the copied numpy host helpers
(prepare_bc, compact_arrays_batch) against the originals, the plain
compose on every case of tests/test_torch_bc_cases.py BC_CASES (the table
the card tests hold csrc/bc_compose.cu to), and every scan the bc ingest
path uses, frames and fused model tensors."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jsplayer_tpu.kernels import sp_recon as J
from jsplayer_tpu_torch.experiments.common import bc_data_pixels
from jsplayer_tpu_torch.kernels import sp_recon as P
from test_torch_bc_cases import BC_CASES, case_commands, run_bc_case
from test_torch_sp_recon import bits, commands, t32, u32

torch.set_num_threads(1)

Y, X = 24, 40
NB = ((Y + 15) // 16) * ((X + 15) // 16)

compose_frame_bc = jax.jit(J.compose_frame_bc)


def bc_inputs(B, T, K=2, seed=0, mv_range=100):
    """Random bc transport: codes 0..K+3 (>= 2+K copy), rects with bounds
    0..20, every plane word random, vectors that wrap and leave the
    frame, changed mostly True."""
    rng = np.random.default_rng(seed)
    init = rng.integers(0, 1 << 32, (B, Y, X), dtype=np.uint64) \
        .astype(np.uint32)
    plane = rng.integers(0, 1 << 32, (B, T, Y, X), dtype=np.uint64) \
        .astype(np.uint32)
    bcode = rng.integers(0, K + 4, (B, T, NB)).astype(np.uint8)
    rloc = rng.integers(0, 21, (B, T, NB, 4)).astype(np.uint8)
    rloc[rng.random((B, T, NB)) < 0.4] = (0, 0, 16, 16)
    mvk = rng.integers(-mv_range, mv_range, (B, T, K, 2)).astype(np.int32)
    changed = rng.random((B, T)) < 0.75
    return init, plane, bcode, rloc, mvk, changed


# -- copied numpy host helpers ---------------------------------------------

@pytest.mark.parametrize("K", [1, 2, 4])
def test_prepare_bc_copy(K):
    bts, mv, rect, payload = commands(5, seed=20 + K)
    for a, b in zip(P.prepare_bc(bts, mv, rect, payload, K),
                    J.prepare_bc(bts, mv, rect, payload, K)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compact_arrays_batch_copy(seed):
    init, plane, bcode, rloc, mvk, changed = bc_inputs(3, 11, seed=seed)
    changed[seed % 3] = False  # an all-stills stream
    arrays = (plane, bcode, rloc, mvk)
    (got, gv, gm), (want, wv, wm) = (
        P.compact_arrays_batch(arrays, changed),
        J.compact_arrays_batch(arrays, changed))
    assert len(got) == len(want) == 4
    for a, b in zip(got + (gv, gm), want + (wv, wm)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# -- compose ----------------------------------------------------------------

def reference_step(prev, plane, bcode, rloc, mvk, chg):
    """The JAX package's bc step per stream: compose_frame_bc where
    changed, prev elsewhere → u32 [B, Y, X]."""
    return np.stack([
        np.asarray(compose_frame_bc(jnp.asarray(prev[b]),
                                    jnp.asarray(plane[b]),
                                    jnp.asarray(bcode[b]),
                                    jnp.asarray(rloc[b]),
                                    jnp.asarray(mvk[b])))
        if chg[b] else prev[b] for b in range(len(chg))])


@pytest.mark.parametrize("name", sorted(BC_CASES))
def test_bc_case_matches_reference(name):
    """bc_compose (the plain twin, through the case's strided layout) on
    every BC_CASES step equals the reference's compose_frame_bc: codes >=
    2+K and 255, rects past 16 or empty, vectors that wrap, are negative,
    near +-2^31 or -2^31 itself, K = 0 and 8, odd shapes, B = 1 and 5."""
    want = reference_step(*case_commands(name))
    _, _, _, got = run_bc_case(name, "cpu")
    np.testing.assert_array_equal(u32(got), want)


def test_bc_plane_outside_data_rects_is_never_used():
    """Garbage in every plane word outside code-1 rects leaves the step
    unchanged (the native transport leaves those words undefined)."""
    init, plane, bcode, rloc, mvk, changed = bc_inputs(2, 1, seed=3)
    chg = torch.ones(2, dtype=torch.bool)
    args = [t32(a[:, 0]) for a in (plane, bcode, rloc, mvk)]
    want = P.bc_compose(t32(init), *args, chg)
    dirty = [torch.where(bc_data_pixels(args[1][b], args[2][b], Y, X),
                         args[0][b], ~args[0][b]) for b in range(2)]
    got = P.bc_compose(t32(init), torch.stack(dirty), *args[1:], chg)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(
        u32(got), reference_step(init, plane[:, 0], bcode[:, 0], rloc[:, 0],
                                 mvk[:, 0], [True, True]))


@pytest.mark.parametrize("mvk", [
    [[0, 0], [1, -1]],
    [[-5, 3], [7, -2]],
    [[X + 3, -Y - 5], [-2 * X - 1, 3 * Y]],      # |mv| >= frame: wraps
    [[-(2**31), 2**31 - 1], [123456, -(2**31)]],  # int32 extremes
])
def test_compose_frame_bc(mvk):
    init, plane, bcode, rloc, _, _ = bc_inputs(1, 1, seed=5)
    mk = np.asarray(mvk, dtype=np.int32)
    want = compose_frame_bc(jnp.asarray(init[0]), jnp.asarray(plane[0, 0]),
                            jnp.asarray(bcode[0, 0]), jnp.asarray(rloc[0, 0]),
                            jnp.asarray(mk))
    args = (t32(init[0]), t32(plane[0, 0]), torch.from_numpy(bcode[0, 0]),
            torch.from_numpy(rloc[0, 0]), t32(mk))
    for fn in (P.compose_frame_bc, P.compose_frame_bc_ref):
        np.testing.assert_array_equal(u32(fn(*args)), np.asarray(want))


def test_bc_row_map_and_row_expand():
    _, _, bcode, rloc, _, _ = bc_inputs(1, 1, seed=6)
    nby, nbx = P.block_grid(Y, X)
    want = J.row_expand(J.bc_row_map(jnp.asarray(bcode[0, 0]),
                                     jnp.asarray(rloc[0, 0]), nby, nbx, X),
                        Y, X)
    got = P.row_expand(P.bc_row_map(torch.from_numpy(bcode[0, 0]),
                                    torch.from_numpy(rloc[0, 0]), nby, nbx,
                                    X), Y, X)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- scans ------------------------------------------------------------------

def torch_args(*arrays):
    return [t32(a) if a.dtype != bool else torch.from_numpy(a)
            for a in arrays]


@pytest.mark.parametrize("B,T,K", [(1, 4, 2), (3, 5, 2), (2, 3, 4)])
def test_decode_batch_bc(B, T, K):
    inputs = bc_inputs(B, T, K, seed=B * 10 + T)
    want = J.decode_batch_bc(*(jnp.asarray(a) for a in inputs))
    got = P.decode_batch_bc(*torch_args(*inputs))
    np.testing.assert_array_equal(u32(got), np.asarray(want))


def test_decode_sequence_bc():
    inputs = [a[0] for a in bc_inputs(1, 6, seed=8)]
    want = J.decode_sequence_bc(*(jnp.asarray(a) for a in inputs))
    got = P.decode_sequence_bc(*torch_args(*inputs))
    np.testing.assert_array_equal(u32(got), np.asarray(want))


@pytest.mark.parametrize("T", [0, 1, 6])
def test_decode_sequence_bc_compact(T):
    init, plane, bcode, rloc, mvk, _ = bc_inputs(1, max(T, 1), seed=9)
    inputs = [init[0]] + [a[0, :T] for a in (plane, bcode, rloc, mvk)]
    want = J.decode_sequence_bc_compact(*(jnp.asarray(a) for a in inputs))
    got = P.decode_sequence_bc_compact(*torch_args(*inputs))
    assert tuple(got.shape) == np.asarray(want).shape
    np.testing.assert_array_equal(u32(got), np.asarray(want))


@pytest.mark.parametrize("downscale,bpp16,layout", [
    (1, False, "NHWC"),
    (1, True, "NCHW"),
    (2, False, "NHWC"),
    (2, True, "NCHW"),
    (4, False, "NHWC"),
])
def test_decode_batch_bc_model(downscale, bpp16, layout):
    inputs = bc_inputs(3, 4, seed=downscale + 20)
    kw = dict(downscale=downscale, bpp16=bpp16, layout=layout)
    wc, wm = J.decode_batch_bc_model(*(jnp.asarray(a) for a in inputs), **kw)
    gc, gm = P.decode_batch_bc_model(*torch_args(*inputs), **kw)
    np.testing.assert_array_equal(u32(gc), np.asarray(wc))
    assert tuple(gm.shape) == wm.shape
    np.testing.assert_array_equal(bits(gm), bits(wm))


@pytest.mark.parametrize("B", [1, 3])
def test_decode_batch_bc_model_packed(B):
    """Packed ds2 emission.  The reference is called one stream at a time:
    its _model_emit pops "packed" from the kwargs dict decode_batch_bc_model
    shares across streams, so a B>1 packed call stacks packed and unpacked
    results and fails (a reference fault, ROADMAP.md queue 3)."""
    inputs = bc_inputs(B, 5, seed=30 + B)
    gc, gm = P.decode_batch_bc_model(*torch_args(*inputs), downscale=2,
                                     packed=True)
    assert gm.dtype == torch.int32
    for b in range(B):
        wc, wm = J.decode_batch_bc_model(
            *(jnp.asarray(a[b:b + 1]) for a in inputs), downscale=2,
            packed=True)
        np.testing.assert_array_equal(u32(gc[b:b + 1]), np.asarray(wc))
        np.testing.assert_array_equal(gm[b:b + 1].numpy(), np.asarray(wm))

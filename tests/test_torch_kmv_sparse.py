"""The port's kmv_sparse step and scans (plain twins, on the CPU) against
jsplayer_tpu's compose_frame_kmv_sparse, decode_batch_kmv_sparse(_ragged)
and decode_sequence_kmv_sparse on the same numpy inputs, bit for bit; the
copied host helper prepare_kmv_sparse by its source text and its outputs;
and the port's native decompress_kmv_sparse against the reference's native
emission and against prepare_kmv_sparse."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jsplayer_tpu import native as JN
from jsplayer_tpu.kernels import sp_recon as J
from jsplayer_tpu_torch import native as PN
from jsplayer_tpu_torch.kernels import sp_recon as P
from test_torch_block_cases import t32
from test_torch_sparse_cases import SPARSE_CASES, case_inputs, sparse_case

torch.set_num_threads(1)


def u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("name", sorted(SPARSE_CASES))
def test_compose_frame_matches_reference(name):
    """Each changed stream's frame: the twin against compose_frame_kmv_sparse
    on the tiles jnp.take gathers (wrapping and filling as the kernel
    must)."""
    prev, bcode, mvk, tiles, idx, yx, chg = case_inputs(name)
    for b in np.nonzero(chg)[0]:
        taken = jnp.take(jnp.asarray(tiles), jnp.asarray(idx[b]), axis=0)
        want = J.compose_frame_kmv_sparse(
            jnp.asarray(prev[b]), jnp.asarray(bcode[b]), jnp.asarray(mvk[b]),
            taken.reshape(-1, 16, 16), jnp.asarray(yx[b]))
        got = P.compose_frame_kmv_sparse_ref(
            t32(prev[b]), torch.from_numpy(bcode[b]), torch.from_numpy(mvk[b]),
            t32(np.asarray(taken)).reshape(-1, 16, 16),
            torch.from_numpy(yx[b]))
        np.testing.assert_array_equal(u32(got), np.asarray(want),
                                      err_msg=f"stream {b}")


@pytest.mark.parametrize("name", sorted(SPARSE_CASES))
def test_ragged_step_matches_reference(name):
    """The case as a one-step window: the port's ragged scan (the wrapper's
    plain branch) against decode_batch_kmv_sparse_ragged, unchanged streams
    and jnp.take's reads included."""
    prev, bcode, mvk, tiles, idx, yx, chg = case_inputs(name)
    want = J.decode_batch_kmv_sparse_ragged(
        jnp.asarray(prev), jnp.asarray(bcode[:, None]),
        jnp.asarray(mvk[:, None]), jnp.asarray(tiles),
        jnp.asarray(idx[:, None]), jnp.asarray(yx[:, None]),
        jnp.asarray(chg[:, None]))
    got = P.decode_batch_kmv_sparse_ragged(
        t32(prev), torch.from_numpy(bcode[:, None]),
        torch.from_numpy(mvk[:, None]), t32(tiles),
        torch.from_numpy(idx[:, None]), torch.from_numpy(yx[:, None]),
        torch.from_numpy(chg[:, None]))
    np.testing.assert_array_equal(u32(got), np.asarray(want))


def window(seed, B=3, T=4, Y=40, X=56, K=2, M=6):
    """A random dense window → (init u32 [B, Y, X], bcode [B, T, NB], mvk
    [B, T, K, 2], tiles u32 [B, T, M, 16, 16], tile_yx [B, T, M, 2],
    changed [B, T]): starts anywhere from 8 outside the frame to 8 past
    it, one stream unchanged at one step."""
    rng = np.random.default_rng(seed)
    nb = ((Y + 15) // 16) * ((X + 15) // 16)
    init = rng.integers(0, 1 << 32, (B, Y, X), dtype=np.uint32)
    bcode = rng.integers(0, K + 3, (B, T, nb)).astype(np.uint8)
    mvk = rng.integers(-3 * X, 3 * X, (B, T, K, 2)).astype(np.int32)
    tiles = rng.integers(0, 1 << 32, (B, T, M, 16, 16), dtype=np.uint32)
    yx = np.stack([rng.integers(-8, Y - 8, (B, T, M)),
                   rng.integers(-8, X - 8, (B, T, M))], -1).astype(np.int32)
    chg = np.ones((B, T), dtype=bool)
    chg[1, 2] = False
    return init, bcode, mvk, tiles, yx, chg


@pytest.mark.parametrize("seed", [0, 1])
def test_dense_scans_match_reference(seed):
    """decode_batch_kmv_sparse (the oracle branch's dense tiles) and
    decode_sequence_kmv_sparse over a 4-step window."""
    arrs = window(seed)
    want = J.decode_batch_kmv_sparse(*(jnp.asarray(a) for a in arrs))
    got = P.decode_batch_kmv_sparse(*(t32(a) if a.dtype == np.uint32
                                      else torch.from_numpy(a)
                                      for a in arrs))
    np.testing.assert_array_equal(u32(got), np.asarray(want))
    one = J.decode_sequence_kmv_sparse(*(jnp.asarray(a[0]) for a in arrs))
    got1 = P.decode_sequence_kmv_sparse(*(t32(a[0]) if a.dtype == np.uint32
                                          else torch.from_numpy(a[0])
                                          for a in arrs))
    np.testing.assert_array_equal(u32(got1), np.asarray(one))


def test_compose_frame_signature_and_zero_tiles():
    """compose_frame_kmv_sparse (the reference's signature, through the
    wrapper) with M tiles and with none."""
    prev, bcode, mvk, tiles, idx, yx, chg = case_inputs("offgrid")
    taken = tiles[np.clip(idx[0], 0, len(tiles) - 1)].reshape(-1, 16, 16)
    for m in (taken.shape[0], 0):
        want = J.compose_frame_kmv_sparse(
            jnp.asarray(prev[0]), jnp.asarray(bcode[0]), jnp.asarray(mvk[0]),
            jnp.asarray(taken[:m]), jnp.asarray(yx[0, :m]))
        got = P.compose_frame_kmv_sparse(
            t32(prev[0]), torch.from_numpy(bcode[0]),
            torch.from_numpy(mvk[0]), t32(taken[:m]),
            torch.from_numpy(yx[0, :m]))
        np.testing.assert_array_equal(u32(got), np.asarray(want))


def test_frames_smaller_than_a_tile_raise():
    """dynamic_update_slice refuses a 16x16 tile into a smaller frame; so
    do the twin and the wrapper."""
    prev, args, chg = sparse_case("m1")
    with pytest.raises(ValueError, match="16x16"):
        P.kmv_sparse_compose(prev[:, :15], args[0][:, :1], *args[1:], chg)
    with pytest.raises(ValueError, match="16x16"):
        P.compose_frame_kmv_sparse_ref(prev[0, :, :12], args[0][0],
                                       args[1][0], args[2][:1].reshape(
                                           1, 16, 16), args[4][0])


def test_gather_from_zero_rows_raises():
    prev, args, chg = sparse_case("m1")
    with pytest.raises(IndexError):
        P.kmv_sparse_compose(prev, args[0], args[1], args[2][:0], *args[3:],
                             chg)


# -- the host helper -----------------------------------------------------------

def test_prepare_kmv_sparse_is_a_verbatim_copy():
    assert inspect.getsource(P.prepare_kmv_sparse) == \
        inspect.getsource(J.prepare_kmv_sparse)


def capture_stream(X=64, Y=40, n=9, seed=13):
    """tests/test_native.py's sparse stream (partial bottom block row):
    scrolls and paints → (frame chunks, the native capture dict)."""
    enc = JN.NativeScreenPressorEncoder(4, X, Y)
    rng = np.random.default_rng(seed)
    f = np.full((Y, X), 0x0A0B0C, dtype=np.uint32)
    f[8:24, 16:48] = 0x445566
    streams = [enc.encode_i(f.reshape(-1))]
    for t in range(n - 1):
        nf = f.copy()
        if t % 3 == 0:
            nf[2:, :] = nf[:-2, :]
        elif t % 3 == 1:
            nf[4:9, 3:17] = int(rng.integers(0, 1 << 24))
        f = nf
        streams.append(enc.encode_p(f.reshape(-1)))
    return streams, JN.native_sp_decode_streams([streams], X, Y)


@pytest.mark.parametrize("K", [1, 2, 4])
@pytest.mark.parametrize("prev0", [False, True])
@pytest.mark.parametrize("M", [None, 40])
def test_prepare_kmv_sparse_copy(K, prev0, M):
    _, cap = capture_stream()
    args = (cap["bts"][0][1:], cap["mv"][0][1:], cap["rect"][0][1:],
            cap["payload"][0][1:])
    kw = dict(K=K, M=M, prev0=cap["payload"][0][0] if prev0 else None)
    got = P.prepare_kmv_sparse(*args, **kw)
    want = J.prepare_kmv_sparse(*args, **kw)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_prepare_kmv_sparse_copy_refuses_small_m():
    _, cap = capture_stream()
    args = (cap["bts"][0], cap["mv"][0], cap["rect"][0], cap["payload"][0])
    for fn in (P.prepare_kmv_sparse, J.prepare_kmv_sparse):
        with pytest.raises(ValueError, match="max tiles"):
            fn(*args, K=2, M=1)


def test_native_kmv_sparse_matches_reference_and_prepare():
    """The port's native decompress_kmv_sparse frame by frame: the same
    results and buffers as the reference's native call, and (the
    tests/test_native.py pattern) the same codes, vectors, tiles and starts
    as prepare_kmv_sparse with prev0."""
    X, Y = 64, 40
    streams, cap = capture_stream(X, Y)
    bc_ref, mvk_ref, tiles_ref, tyx_ref = P.prepare_kmv_sparse(
        cap["bts"][0][1:], cap["mv"][0][1:], cap["rect"][0][1:],
        cap["payload"][0][1:], K=2, prev0=cap["payload"][0][0])
    M = tiles_ref.shape[1]
    nb = ((X + 15) // 16) * ((Y + 15) // 16)
    decs = {}
    for mod in (JN, PN):
        d = mod.NativeScreenPressor(X, Y, 24)
        d.preinit(0)
        decs[mod] = (d, np.zeros(nb, np.uint8), np.zeros((2, 2), np.int32),
                     np.zeros((M, 16, 16), np.uint32),
                     np.zeros((M, 2), np.int32))
    for t, s in enumerate(streams):
        res = {}
        for mod, (d, *bufs) in decs.items():
            res[mod] = d.decompress_kmv_sparse(s, d.is_key_frame(s), *bufs,
                                               K=2)
        assert res[PN] == res[JN]
        for a, b in zip(decs[PN][1:], decs[JN][1:]):
            np.testing.assert_array_equal(a, b)
        chg, _, m_used = res[PN]
        if t == 0:
            assert m_used == -1  # a keyframe overflows M: shipped dense
            continue
        if not chg:
            continue
        _, bc, mvk, tiles, tyx = decs[PN]
        for got, want in ((bc, bc_ref), (mvk, mvk_ref), (tiles, tiles_ref),
                          (tyx, tyx_ref)):
            np.testing.assert_array_equal(got, want[t - 1], err_msg=str(t))

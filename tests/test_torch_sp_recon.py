"""The port's kmv reconstruction (jsplayer_tpu_torch.kernels.sp_recon)
against the JAX package's, bit for bit, on the CPU: the copied numpy host
helpers against the originals, the plain compose (wrapping and
out-of-frame motion vectors included) and every scan the ingest path
uses, frames and fused model tensors."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jsplayer_tpu.kernels import sp_recon as J
from jsplayer_tpu_torch.kernels import sp_recon as P

torch.set_num_threads(1)

Y, X = 24, 40


def t32(a):
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def u32(t):
    return t.numpy().view(np.uint32)


def bits(x):
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x)
    if a.dtype == jnp.bfloat16:
        return a.view(np.int16)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def kmv_inputs(B, T, K=2, seed=0, mv_range=100):
    """Random kmv transport: every ptype (3 = copy too) and kslot (>= K
    never matches), vectors that wrap and leave the frame."""
    rng = np.random.default_rng(seed)
    init = rng.integers(0, 1 << 24, (B, Y, X)).astype(np.uint32)
    word = (rng.integers(0, 1 << 24, (B, T, Y, X)).astype(np.uint32)
            | (rng.integers(0, 4, (B, T, Y, X)).astype(np.uint32) << 24)
            | (rng.integers(0, 8, (B, T, Y, X)).astype(np.uint32) << 26))
    mvk = rng.integers(-mv_range, mv_range, (B, T, K, 2)).astype(np.int32)
    changed = rng.random((B, T)) < 0.75
    return init, word, mvk, changed


def commands(T, seed=0):
    """Random captured SP commands (bts 0..4, vectors, block rects) and
    payload frames for the numpy host helpers."""
    rng = np.random.default_rng(seed)
    nbx, nby = (X + 15) // 16, (Y + 15) // 16
    nb = nbx * nby
    bts = rng.integers(0, 5, (T, nb)).astype(np.int32)
    mv = rng.integers(-3, 4, (T, nb, 2)).astype(np.int32)
    bx = (np.arange(nb) % nbx) * 16
    by = (np.arange(nb) // nbx) * 16
    x1 = bx + rng.integers(0, 8, (T, nb))
    y1 = by + rng.integers(0, 8, (T, nb))
    rect = np.stack([x1, y1, x1 + rng.integers(1, 9, (T, nb)),
                     y1 + rng.integers(1, 9, (T, nb))], -1).astype(np.int32)
    payload = rng.integers(0, 1 << 32, (T, Y, X), dtype=np.uint64
                           ).astype(np.uint32)
    return bts, mv, rect, payload


# -- copied numpy host helpers ---------------------------------------------

@pytest.mark.parametrize("K", [1, 2, 4])
def test_derive_kmv_commands_copy(K):
    bts, mv, rect, _ = commands(6, seed=K)
    for a, b in zip(P.derive_kmv_commands(bts, mv, rect, K),
                    J.derive_kmv_commands(bts, mv, rect, K)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("K", [1, 2, 4])
def test_prepare_kmv_copy(K):
    bts, mv, rect, payload = commands(5, seed=10 + K)
    for a, b in zip(P.prepare_kmv(bts, mv, rect, payload, K),
                    J.prepare_kmv(bts, mv, rect, payload, K)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_compact_changed_copy():
    _, word, mvk, changed = kmv_inputs(1, 9, seed=2)
    for a, b in zip(P.compact_changed(word[0], mvk[0], changed[0]),
                    J.compact_changed(word[0], mvk[0], changed[0])):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compact_changed_batch_copy(seed):
    _, word, mvk, changed = kmv_inputs(3, 11, seed=seed)
    changed[seed % 3] = False  # an all-stills stream
    for a, b in zip(P.compact_changed_batch(word, mvk, changed),
                    J.compact_changed_batch(word, mvk, changed)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_elision_bucket_copy():
    for cap in (1, 4, 6, 7, 16, 64, 100):
        for n in range(-1, cap + 2):
            for nb in (1, 3, 8):
                assert P._elision_bucket(n, cap, nb) == \
                    J._elision_bucket(n, cap, nb)


# -- compose ----------------------------------------------------------------

@pytest.mark.parametrize("mvk", [
    [[0, 0], [1, -1]],
    [[-5, 3], [7, -2]],
    [[X + 3, -Y - 5], [-2 * X - 1, 3 * Y]],      # |mv| >= frame: wraps
    [[-1000, 999], [123456, -654321]],           # far out of frame
])
def test_compose_frame_kmv(mvk):
    init, word, _, _ = kmv_inputs(1, 1, seed=5)
    mk = np.asarray(mvk, dtype=np.int32)
    want = J.compose_frame_kmv(jnp.asarray(init[0]), jnp.asarray(word[0, 0]),
                               jnp.asarray(mk))
    for fn in (P.compose_frame_kmv, P.compose_frame_kmv_ref):
        got = fn(t32(init[0]), t32(word[0, 0]), t32(mk))
        np.testing.assert_array_equal(u32(got), np.asarray(want))


def test_kmv_compose_batched_into_strided_out():
    """The batched step writes into a strided view (frames[:, t]) and
    copies unchanged streams."""
    init, word, mvk, _ = kmv_inputs(3, 1, K=3, seed=6)
    chg = np.array([True, False, True])
    stack = torch.zeros((3, 2, Y, X), dtype=torch.int32)
    P.kmv_compose(t32(init), t32(word[:, 0]), t32(mvk[:, 0]),
                  torch.from_numpy(chg), out=stack[:, 1])
    for b in range(3):
        want = (J.compose_frame_kmv(jnp.asarray(init[b]),
                                    jnp.asarray(word[b, 0]),
                                    jnp.asarray(mvk[b, 0]))
                if chg[b] else init[b])
        np.testing.assert_array_equal(u32(stack[b, 1]), np.asarray(want))
    assert not stack[:, 0].any()


# -- scans ------------------------------------------------------------------

@pytest.mark.parametrize("B,T,K", [(1, 4, 2), (3, 5, 2), (2, 3, 4)])
def test_decode_batch_kmv(B, T, K):
    init, word, mvk, changed = kmv_inputs(B, T, K, seed=B * 10 + T)
    want = J.decode_batch_kmv(jnp.asarray(init), jnp.asarray(word),
                              jnp.asarray(mvk), jnp.asarray(changed))
    got = P.decode_batch_kmv(t32(init), t32(word), t32(mvk),
                             torch.from_numpy(changed))
    np.testing.assert_array_equal(u32(got), np.asarray(want))


def test_decode_sequence_kmv():
    init, word, mvk, changed = kmv_inputs(1, 6, seed=8)
    want = J.decode_sequence_kmv(jnp.asarray(init[0]), jnp.asarray(word[0]),
                                 jnp.asarray(mvk[0]), jnp.asarray(changed[0]))
    got = P.decode_sequence_kmv(t32(init[0]), t32(word[0]), t32(mvk[0]),
                                torch.from_numpy(changed[0]))
    np.testing.assert_array_equal(u32(got), np.asarray(want))


@pytest.mark.parametrize("T", [0, 1, 6])
def test_decode_sequence_kmv_compact(T):
    init, word, mvk, _ = kmv_inputs(1, max(T, 1), seed=9)
    word, mvk = word[:, :T], mvk[:, :T]
    want = J.decode_sequence_kmv_compact(
        jnp.asarray(init[0]), jnp.asarray(word[0]), jnp.asarray(mvk[0]))
    got = P.decode_sequence_kmv_compact(t32(init[0]), t32(word[0]),
                                        t32(mvk[0]))
    assert tuple(got.shape) == np.asarray(want).shape
    np.testing.assert_array_equal(u32(got), np.asarray(want))


@pytest.mark.parametrize("downscale,packed,bpp16,layout", [
    (1, False, False, "NHWC"),
    (1, False, True, "NCHW"),
    (2, False, False, "NHWC"),
    (2, False, True, "NCHW"),
    (4, False, False, "NHWC"),
])
def test_decode_batch_kmv_model(downscale, packed, bpp16, layout):
    init, word, mvk, changed = kmv_inputs(3, 4, seed=downscale + 20)
    kw = dict(downscale=downscale, bpp16=bpp16, layout=layout,
              packed=packed)
    wc, wm = J.decode_batch_kmv_model(
        jnp.asarray(init), jnp.asarray(word), jnp.asarray(mvk),
        jnp.asarray(changed), **kw)
    gc, gm = P.decode_batch_kmv_model(
        t32(init), t32(word), t32(mvk), torch.from_numpy(changed), **kw)
    np.testing.assert_array_equal(u32(gc), np.asarray(wc))
    assert tuple(gm.shape) == wm.shape
    np.testing.assert_array_equal(bits(gm), bits(wm))


@pytest.mark.parametrize("B", [1, 3])
def test_decode_batch_kmv_model_packed(B):
    """Packed ds2 emission.  The reference is called one stream at a time:
    its _model_emit pops "packed" from the kwargs dict its batch loop
    shares, so a B>1 packed call stacks packed and unpacked results and
    fails (a reference fault, ROADMAP.md queue 3)."""
    init, word, mvk, changed = kmv_inputs(B, 5, seed=30 + B)
    gc, gm = P.decode_batch_kmv_model(
        t32(init), t32(word), t32(mvk), torch.from_numpy(changed),
        downscale=2, packed=True)
    for b in range(B):
        wc, wm = J.decode_batch_kmv_model(
            jnp.asarray(init[b:b + 1]), jnp.asarray(word[b:b + 1]),
            jnp.asarray(mvk[b:b + 1]), jnp.asarray(changed[b:b + 1]),
            downscale=2, packed=True)
        np.testing.assert_array_equal(u32(gc[b:b + 1]), np.asarray(wc))
        assert gm.dtype == torch.int32
        np.testing.assert_array_equal(gm[b:b + 1].numpy(), np.asarray(wm))


@pytest.mark.parametrize("downscale,packed", [(1, False), (2, False),
                                              (2, True)])
def test_decode_sequence_kmv_compact_model(downscale, packed):
    init, word, mvk, _ = kmv_inputs(1, 5, seed=40 + downscale)
    kw = dict(downscale=downscale, packed=packed)
    wc, wm = J.decode_sequence_kmv_compact_model(
        jnp.asarray(init[0]), jnp.asarray(word[0]), jnp.asarray(mvk[0]), **kw)
    gc, gm = P.decode_sequence_kmv_compact_model(
        t32(init[0]), t32(word[0]), t32(mvk[0]), **kw)
    np.testing.assert_array_equal(u32(gc), np.asarray(wc))
    np.testing.assert_array_equal(bits(gm), bits(wm))


def test_model_packed_needs_downscale_2():
    init, word, mvk, changed = kmv_inputs(1, 2, seed=1)
    with pytest.raises(ValueError, match="downscale == 2"):
        P.decode_batch_kmv_model(t32(init), t32(word), t32(mvk),
                                 torch.from_numpy(changed), packed=True)

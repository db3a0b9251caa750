"""The port's sparse payload transport (jsplayer_tpu_torch.kernels.
sparse_payload, plain twins on the CPU) against jsplayer_tpu's, bit for
bit, on the same numpy inputs: the pack/unpack round trip and the
bit-exact sparse decode of tests/test_sparse_payload.py, PAYLOAD_CASES'
edges of the one-hot product (repeated blocks, indices outside [0, NB),
words that round through f32 and saturate, no tiles), windows with a
leading T axis and strided views, and the errors both packages raise
(m_max overflow, a 1080-row frame)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jsplayer_tpu.encode.sp_enc import ScreenPressorEncoder, pack_rgb
from jsplayer_tpu.kernels import sparse_payload as J
from jsplayer_tpu.pipeline.batch import stack_sp_commands
from jsplayer_tpu_torch.kernels import sparse_payload as P
from jsplayer_tpu_torch.kernels.sp_recon import decode_sequence
from test_torch_payload_cases import (NB, PAYLOAD_CASES, X, Y, case_inputs,
                                      window_inputs)

torch.set_num_threads(1)


def t32(a):
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def u32(t):
    return t.numpy().view(np.uint32)


def reference(tiles, tb, nb=NB, y=Y, x=X):
    return np.asarray(J.unpack_payload(jnp.asarray(tiles), jnp.asarray(tb),
                                       nb, y, x))


@pytest.mark.parametrize("name", sorted(PAYLOAD_CASES))
def test_unpack_payload_cases_match_reference(name):
    tiles, tb = case_inputs(name)
    want = reference(tiles, tb)
    got = P.unpack_payload(t32(tiles), t32(tb), NB, Y, X)
    np.testing.assert_array_equal(u32(got), want)
    np.testing.assert_array_equal(
        u32(P.unpack_payload_ref(t32(tiles), t32(tb), NB, Y, X)), want)


def test_f32_rounding_case_holds_the_reference_bits():
    """What the one-hot product gives for the case table's words: 2^24 + 1
    plus 5 on block 0 is 16777220, 0xFFFFFFFF stays, ties round to even."""
    tiles, tb = case_inputs("f32_rounding")
    got = u32(P.unpack_payload(t32(tiles), t32(tb), NB, Y, X))
    assert (got[:16, :16] == 16777220).all()
    by, bx = divmod(4, X // 16)
    blk = got[by * 16:(by + 1) * 16, bx * 16:(bx + 1) * 16].reshape(256)
    assert (blk[:8] == 0xFFFFFFFF).all()
    assert (blk[8:16] == (1 << 24) + 4).all()
    by, bx = divmod(7, X // 16)
    blk = got[by * 16:(by + 1) * 16, bx * 16:(bx + 1) * 16].reshape(256)
    assert list(blk[:4]) == [0xFFFFFF00, 0xFFFFFFFF, 0xFFFFFFFF, 0x80000000]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pack_unpack_roundtrip_matches_reference(seed):
    """tests/test_sparse_payload.py's round trip: active blocks (bts 1, 2,
    4) come back, motion blocks (bts 3) and the rest are 0."""
    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 1 << 24, (Y, X)).astype(np.uint32)
    bts = rng.integers(0, 5, NB).astype(np.int32)
    tiles, blocks = P.pack_tiles(payload, bts, m_max=NB)
    jt, jb = J.pack_tiles(payload, bts, m_max=NB)
    np.testing.assert_array_equal(tiles, jt)
    np.testing.assert_array_equal(blocks, jb)
    got = u32(P.unpack_payload(t32(tiles), t32(blocks), NB, Y, X))
    np.testing.assert_array_equal(got, reference(jt, jb))
    keep = ((bts > 0) & (bts != 3)).reshape(Y // 16, 1, X // 16, 1)
    keep = np.broadcast_to(keep, (Y // 16, 16, X // 16, 16)).reshape(Y, X)
    np.testing.assert_array_equal(got, np.where(keep, payload, 0))


@pytest.mark.parametrize("T,M", [(1, 4), (3, 8), (5, 12)])
def test_window_with_a_leading_t_axis(T, M):
    """tiles [T, M, 256] → [T, Y, X], frame t the reference's unpack of
    frame t (pads, indices >= NB and a pair on one block in every
    frame)."""
    tiles, tb = window_inputs(T, M, seed=T * 10 + M)
    got = u32(P.unpack_payload(t32(tiles), t32(tb), NB, Y, X))
    assert got.shape == (T, Y, X)
    for t in range(T):
        np.testing.assert_array_equal(got[t], reference(tiles[t], tb[t]))


def test_strided_views():
    """Every other tile of a [T, 2M, 256] window, and 256-word rows of a
    [T, M, 260] buffer."""
    tiles, tb = window_inputs(2, 16, seed=5)
    view = t32(tiles)[:, ::2]
    wide = torch.zeros((2, 16, 260), dtype=torch.int32)
    wide[..., 4:] = t32(tiles)
    got = P.unpack_payload(view, t32(tb)[:, ::2].contiguous(), NB, Y, X)
    got_wide = P.unpack_payload(wide[..., 4:], t32(tb), NB, Y, X)
    for t in range(2):
        np.testing.assert_array_equal(
            u32(got[t]), reference(tiles[t, ::2], tb[t, ::2]))
        np.testing.assert_array_equal(u32(got_wide[t]),
                                      reference(tiles[t], tb[t]))


def test_unpack_payload_rejects_a_mismatched_grid():
    tiles, tb = case_inputs("packed")
    for nb, y, x in ((NB + 1, Y, X), (NB, Y + 16, X), (NB, Y - 8, X + 16)):
        with pytest.raises(ValueError, match="16x16"):
            P.unpack_payload(t32(tiles), t32(tb), nb, y, x)


def test_m_max_overflow_raises_as_the_reference():
    payload = np.zeros((Y, X), np.uint32)
    bts = np.ones(NB, np.int32)
    for mod in (J, P):
        with pytest.raises(ValueError, match="m_max=3 < active blocks 8"):
            mod.pack_tiles(payload, bts, m_max=3)
        with pytest.raises(ValueError, match="m_max"):
            mod.pack_sequence(payload[None], bts[None], m_max=3)


def test_1080_row_frame_raises_in_both_packages():
    """Reference fault 9: pack_tiles reshapes to (Y // 16, 16, ...), which
    a 1080-row frame does not fill; the port mirrors it."""
    payload = np.zeros((1080, 1920), np.uint32)
    bts = np.zeros(68 * 120, np.int32)
    msgs = []
    for mod in (J, P):
        with pytest.raises(ValueError, match="cannot reshape") as e:
            mod.pack_tiles(payload, bts, m_max=4)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def sp_stream(seed, T=5):
    """tests/test_sparse_payload.py's stream: a flat I-frame, then P-frames
    alternating a 2-row scroll and a painted rect → (chunks, gold frames
    [T+1, Y*X] u32)."""
    enc = ScreenPressorEncoder(4, X, Y)
    rng = np.random.default_rng(seed)
    f = np.full((Y, X), pack_rgb(7, 7, 7), dtype=np.uint32).reshape(-1)
    streams, golds = [enc.encode_i(f)], [f]
    for t in range(T):
        nf = f.copy().reshape(Y, X)
        if t % 2 == 0:
            nf[2:, :] = nf[:-2, :].copy()
        else:
            nf[10:14, 40:60] = pack_rgb(*rng.integers(0, 256, 3))
        f = nf.reshape(-1)
        streams.append(enc.encode_p(f))
        golds.append(f)
    return streams, np.stack(golds)


@pytest.mark.parametrize("seed,ib", [(1, 0), (2, 3), (3, 6)])
def test_decode_sequence_sparse_matches_reference(seed, ib):
    """The reference's bit-exact decode: every frame the source frame, each
    frame and significance flag the reference's, and the port's frames
    those of decode_sequence on the dense payload."""
    streams, golds = sp_stream(seed)
    cmds = stack_sp_commands([streams], X, Y)
    bts = cmds["bts"][0, 0]
    m_max = int(((bts > 0) & (bts != 3)).sum(axis=1).max())
    tiles, blocks = J.pack_sequence(cmds["payload"][0, 0], bts, m_max)
    pt, pb = P.pack_sequence(cmds["payload"][0, 0], bts, m_max)
    np.testing.assert_array_equal(pt, tiles)
    np.testing.assert_array_equal(pb, blocks)
    args = [cmds[k][0, 0] for k in ("mv", "rect")]
    chg = cmds["changed"][0, 0]
    jf, js = J.decode_sequence_sparse(
        jnp.zeros((Y, X), jnp.uint32), jnp.array(bts),
        *(jnp.array(a) for a in args), jnp.array(tiles), jnp.array(blocks),
        jnp.array(chg), jnp.int32(ib))
    init = torch.zeros((Y, X), dtype=torch.int32)
    pf, ps = P.decode_sequence_sparse(
        init, t32(bts), *(t32(a) for a in args), t32(tiles), t32(blocks),
        torch.from_numpy(chg), ib)
    np.testing.assert_array_equal(u32(pf), np.asarray(jf))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_array_equal(u32(pf).reshape(len(golds), -1), golds)
    df, ds = decode_sequence(init, t32(bts), *(t32(a) for a in args),
                             t32(cmds["payload"][0, 0]),
                             torch.from_numpy(chg), ib)
    assert torch.equal(pf, df) and torch.equal(ps, ds)

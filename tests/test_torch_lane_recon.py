"""The port's lane decode (jsplayer_tpu_torch.kernels.lane_recon) against
the JAX package's jsplayer_tpu.kernels.lane_recon, bit for bit, on the CPU:
the plain compose on every case of tests/test_torch_lane_cases.py
LANE_CASES (the table the card tests hold csrc/bc_compose.cu's lane
instance to), the reference's out-of-range gathers, units and the
window's rows, and the window and batch decodes on transcoded containers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jsplayer_tpu.codecs import lane_format
from jsplayer_tpu.kernels import lane_recon as J
from jsplayer_tpu.transcode import transcode_to_lane
from jsplayer_tpu_torch.kernels import lane_recon as P
from test_lane_container import make_avi
from test_torch_lane_cases import LANE_CASES, case_inputs, run_lane_case
from test_torch_sp_recon import t32, u32

torch.set_num_threads(1)

compose_frame_lane = jax.jit(J.compose_frame_lane)


def reference_step(prev, rows, row_idx, bcode, rloc, mvk, chg):
    """The JAX package's lane step per stream: compose_frame_lane where
    changed, prev elsewhere → u32 [B, Y, X]."""
    return np.stack([
        np.asarray(compose_frame_lane(*(jnp.asarray(a[b]) for a in (
            prev, rows, row_idx, bcode, rloc, mvk))))
        if chg[b] else prev[b] for b in range(len(chg))])


@pytest.mark.parametrize("name", sorted(LANE_CASES))
def test_lane_case_matches_reference(name):
    """lane_compose (the plain twin, through the case's strided layout) on
    every LANE_CASES step equals the reference's compose_frame_lane: row
    indices that wrap or fall outside the rows (0xFFFFFFFF), rows with the
    top byte set (no mask), codes >= 2+K and 255, rects past 16 or empty,
    vectors near +-2^31, -2^31 itself and |mv| >= Y, X, K = 0 and 8."""
    want = reference_step(*case_inputs(name))
    _, _, _, got = run_lane_case(name, "cpu")
    np.testing.assert_array_equal(u32(got), want)


@pytest.mark.parametrize("mvk", [
    [[0, 0], [1, -1]],
    [[24 + 3, -40 - 5], [-2 * 24 - 1, 3 * 40]],    # |mv| >= frame: wraps
    [[-(2**31), 2**31 - 9], [123456, -(2**31)]],  # int32 extremes
])
def test_compose_frame_lane(mvk):
    """The reference's single-frame signature, through the wrapper and the
    twin, on the motion vectors of the bc tests."""
    prev, rows, row_idx, bcode, rloc, _, _ = case_inputs("y_not_16")
    Y, X = 40, 128
    mk = np.asarray(mvk, dtype=np.int32)
    args = (prev[0], rows[0], row_idx[0], bcode[0], rloc[0], mk)
    want = compose_frame_lane(*(jnp.asarray(a) for a in args))
    targs = (t32(prev[0]), t32(rows[0]), torch.from_numpy(row_idx[0]),
             torch.from_numpy(bcode[0]), torch.from_numpy(rloc[0]), t32(mk))
    assert tuple(want.shape) == (Y, X)
    for fn in (P.compose_frame_lane, P.compose_frame_lane_ref):
        np.testing.assert_array_equal(u32(fn(*targs)), np.asarray(want))


def test_take_rows_matches_jnp_take():
    """Indices in range, in [-n, -1] (wrap) and outside both: jnp.take's
    fill reads 0xFFFFFFFF; an empty source raises as jnp.take does."""
    rng = np.random.default_rng(3)
    src = rng.integers(0, 1 << 32, (5, 7), dtype=np.uint32)
    idx = np.array([[0, 4, -1, -5], [-6, 5, 2**31 - 1, -(2**31)]],
                   dtype=np.int32)
    want = np.asarray(jnp.take(jnp.asarray(src), jnp.asarray(idx), axis=0))
    got = P.take_rows(t32(src), torch.from_numpy(idx))
    np.testing.assert_array_equal(u32(got), want)
    assert (want[1, :1] == 0xFFFFFFFF).all()
    empty = np.zeros((0, 7), np.uint32)
    with pytest.raises(IndexError):
        jnp.take(jnp.asarray(empty), jnp.asarray(idx), axis=0)
    with pytest.raises(IndexError):
        P.take_rows(t32(empty), torch.from_numpy(idx))


# -- units and rows -----------------------------------------------------------

def test_units_from_raw():
    payload = np.random.default_rng(1).integers(0, 256, (9, 3, 128),
                                                 dtype=np.uint8)
    want = J.units_from_raw(jnp.asarray(payload))
    got = P.units_from_raw(torch.from_numpy(payload))
    np.testing.assert_array_equal(u32(got), np.asarray(want))


@pytest.mark.parametrize("U,pad", [(3, 0), (5, 2), (1, 7)])
def test_units_from_pack(U, pad):
    """rANS-coded units, with U bucketed past the real count (padded units
    decode to rows nothing references)."""
    from jsplayer_tpu.kernels import rans_lanes as JR

    rng = np.random.default_rng(U)
    syms = rng.integers(0, 256, U * 384).astype(np.uint8)
    N = 64
    freq = JR.build_freq_table(syms)
    lane_bytes, states, ns = JR.encode_lanes(syms, freq, N)
    steps = -(-3 * (U + pad) * 128 // N)
    refills = JR.layout_refills(lane_bytes, states, freq, steps)
    want = J.units_from_pack(jnp.asarray(refills), jnp.asarray(states),
                             jnp.asarray(freq), U + pad)
    got = P.units_from_pack(torch.from_numpy(refills), t32(states),
                            torch.from_numpy(freq), U + pad)
    np.testing.assert_array_equal(u32(got), np.asarray(want))


@pytest.mark.parametrize("X", [64, 128, 200, 300])
def test_rows_from_units(X):
    """Unique rows from units through row_table, in-range and out-of-range
    ids (the [:, :X] view of [Ur, ncol*128])."""
    rng = np.random.default_rng(X)
    ncol = -(-X // 128)
    units = rng.integers(0, 1 << 24, (6, 128), dtype=np.uint32)
    row_table = rng.integers(-8, 8, (5, ncol)).astype(np.int32)
    want = J.rows_from_units(jnp.asarray(units), jnp.asarray(row_table), X)
    got = P.rows_from_units(t32(units), torch.from_numpy(row_table), X)
    assert tuple(got.shape) == (5, X)
    np.testing.assert_array_equal(u32(got), np.asarray(want))


# -- windows and batches on transcoded containers ------------------------------

def containers(payload, n=2, X=64, Y=48, T=10, key_every=0, window=4):
    """Lane containers of n make_avi streams (shared window boundaries;
    with no keyframe past frame 0 every window holds a paint)."""
    return [lane_format.container_from_bytes(transcode_to_lane(
        make_avi(s, X, Y, T, key_every=key_every)[0], window=window, K=2,
        payload=payload)) for s in range(n)]


def window_args(w, X, Y):
    """The reference's per-window arrays of LaneWindow w (numpy)."""
    rt, ri = w.row_index(Y, lane_format.plane_cols(X) // 128)
    return [w.btype, w.rect, w.mvk, rt, ri, w.changed]


def torch_args(arrays):
    return [t32(a) if a.dtype != bool else torch.from_numpy(a)
            for a in arrays]


@pytest.mark.parametrize("payload", ["raw", "rans"])
def test_decode_window(payload):
    """decode_window_raw / decode_window_lane over every window of a
    stream, chained on the carry, frames equal to the reference's."""
    X, Y = 64, 48
    (c,) = containers(payload, n=1)
    carry = np.zeros((Y, X), np.uint32)
    for w in c.windows:
        args = window_args(w, X, Y)
        if payload == "raw":
            init = carry
            want = J.decode_window_raw(jnp.asarray(init),
                                       jnp.asarray(w.payload),
                                       *map(jnp.asarray, args))
            got = P.decode_window_raw(t32(init),
                                      torch.from_numpy(w.payload),
                                      *torch_args(args))
        else:
            init = w.init_plane if w.init_plane is not None else carry
            bulk = (w.refills, w.states, w.freq)
            want = J.decode_window_lane(jnp.asarray(init),
                                        *map(jnp.asarray, bulk),
                                        *map(jnp.asarray, args),
                                        U=w.n_units)
            got = P.decode_window_lane(t32(init), *torch_args(bulk),
                                       *torch_args(args), U=w.n_units)
        np.testing.assert_array_equal(u32(got), np.asarray(want))
        carry = np.asarray(want)[-1]


def batch_inputs(conts, wi, payload):
    """Window wi of every container padded to shared shapes (as the
    ingest pads): T, U and Ur to the batch's largest, steps to cover
    3*U*128 symbols."""
    X, Y, N = conts[0].X, conts[0].Y, conts[0].n_lanes
    ws = [c.windows[wi] for c in conts]
    B, T = len(ws), max(w.T for w in ws)
    per = [window_args(w, X, Y) for w in ws]
    U = max(w.n_units for w in ws)
    Ur = max(p[3].shape[0] for p in per)
    out = []
    for k, a in enumerate(zip(*per)):
        shape = ((B, Ur) + a[0].shape[1:] if k == 3
                 else (B, T) + a[0].shape[1:])
        z = np.zeros(shape, a[0].dtype)
        for b, x in enumerate(a):
            z[b, : x.shape[0]] = x
        out.append(z)
    if payload == "raw":
        pay = np.zeros((B, U, 3, 128), np.uint8)
        for b, w in enumerate(ws):
            pay[b, : w.n_units] = w.payload
        return [pay], out, U
    steps = max(max(w.refills.shape[0] for w in ws), -(-3 * U * 128 // N))
    refills = np.zeros((B, steps, N, 2), np.uint8)
    for b, w in enumerate(ws):
        refills[b, : w.refills.shape[0]] = w.refills
    return ([refills, np.stack([w.states for w in ws]),
             np.stack([w.freq for w in ws])], out, U)


@pytest.mark.parametrize("payload", ["raw", "rans"])
def test_decode_batch(payload):
    """decode_batch_raw / decode_batch_lane (one compose launch a step for
    all B) over B=3 streams, window by window, against the reference's
    batch functions."""
    X, Y = 64, 48
    conts = containers(payload, n=3)
    carry = np.zeros((3, Y, X), np.uint32)
    for wi in range(len(conts[0].windows)):
        bulk, args, U = batch_inputs(conts, wi, payload)
        init = carry.copy()
        for b, c in enumerate(conts):
            if c.windows[wi].init_plane is not None:
                init[b] = c.windows[wi].init_plane
        if payload == "raw":
            want = J.decode_batch_raw(jnp.asarray(init),
                                      *map(jnp.asarray, bulk + args))
            got = P.decode_batch_raw(t32(init), *torch_args(bulk + args))
        else:
            want = J.decode_batch_lane(jnp.asarray(init),
                                       *map(jnp.asarray, bulk + args), U=U)
            got = P.decode_batch_lane(t32(init), *torch_args(bulk + args),
                                      U=U)
        np.testing.assert_array_equal(u32(got), np.asarray(want))
        carry = np.asarray(want)[:, -1]


@pytest.mark.parametrize("payload", ["raw", "rans"])
def test_window_without_units_raises_as_the_reference(payload):
    """A one-frame still window (keyframes every 5, windows of 4: frame 4
    alone) has no payload unit; its row gather from zero units raises
    IndexError in both packages (the ingest pads U to at least 1)."""
    X, Y = 64, 48
    (c,) = containers(payload, n=1, key_every=5)
    w = next(w for w in c.windows if w.n_units == 0)
    args = window_args(w, X, Y)
    init = np.zeros((Y, X), np.uint32)
    if payload == "raw":
        calls = [lambda: J.decode_window_raw(jnp.asarray(init),
                                             jnp.asarray(w.payload),
                                             *map(jnp.asarray, args)),
                 lambda: P.decode_window_raw(t32(init),
                                             torch.from_numpy(w.payload),
                                             *torch_args(args))]
    else:
        bulk = (w.refills, w.states, w.freq)
        calls = [lambda: J.decode_window_lane(jnp.asarray(init),
                                              *map(jnp.asarray, bulk),
                                              *map(jnp.asarray, args), U=0),
                 lambda: P.decode_window_lane(t32(init), *torch_args(bulk),
                                              *torch_args(args), U=0)]
    for call in calls:
        with pytest.raises(IndexError):
            call()

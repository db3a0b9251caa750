"""The port's multi-lane rANS (jsplayer_tpu_torch.kernels.rans_lanes)
against the JAX package's, bit for bit, on the CPU: the copied numpy host
helpers (text and outputs), both decodes' plain twins against
decode_lanes_aligned / decode_lanes on the grid of tests/test_rans_lanes.py,
on random u32 states (0 and >= 2^31 among them), random refills and past-
end reads, and the round-trip helpers."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jsplayer_tpu.kernels import rans_lanes as J
from jsplayer_tpu_torch.kernels import rans_lanes as P
from test_torch_rans_cases import DISTS, i32, seed_of, symbols, tables, \
    u32_states

torch.set_num_threads(1)

# -- the copied host helpers ---------------------------------------------------

@pytest.mark.parametrize("name", ["build_freq_table", "encode_lanes",
                                  "layout_refills"])
def test_host_helper_is_a_verbatim_copy(name):
    assert inspect.getsource(getattr(P, name)) == \
        inspect.getsource(getattr(J, name))
    assert (P.PROB_BITS, P.PROB_SCALE, P.RANS_L) == \
        (J.PROB_BITS, J.PROB_SCALE, J.RANS_L)


@pytest.mark.parametrize("n_lanes", [1, 8, 128])
@pytest.mark.parametrize("dist", DISTS)
def test_host_helpers_match_reference(n_lanes, dist):
    syms = symbols(dist, 1500, seed_of(n_lanes, dist))
    freq = P.build_freq_table(syms)
    np.testing.assert_array_equal(freq, J.build_freq_table(syms))
    got, want = P.encode_lanes(syms, freq, n_lanes), \
        J.encode_lanes(syms, freq, n_lanes)
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[2] == want[2]
    steps = -(-len(syms) // n_lanes) + 2  # two steps past the symbols
    np.testing.assert_array_equal(
        P.layout_refills(got[0], got[1], freq, steps),
        J.layout_refills(want[0], want[1], freq, steps))


# -- the decodes -----------------------------------------------------------------

@pytest.mark.parametrize("n_lanes", [1, 8, 64, 128])
@pytest.mark.parametrize("dist", DISTS)
def test_decodes_match_reference_on_the_grid(n_lanes, dist):
    """Both twins on encoded symbols, over two steps past the last symbol
    (lanes that hold fewer symbols decode on: the whole [steps, N] output
    must equal the reference's, packed reads past a lane's bytes too)."""
    syms = symbols(dist, 3000, seed_of("grid", n_lanes, dist))
    freq = P.build_freq_table(syms)
    lane_bytes, states, ns = P.encode_lanes(syms, freq, n_lanes)
    steps = -(-ns // n_lanes) + 2
    refills = P.layout_refills(lane_bytes, states, freq, steps)
    want = J.decode_lanes_aligned(jnp.asarray(refills), jnp.asarray(states),
                                  jnp.asarray(freq))
    got = P.decode_lanes_aligned(torch.from_numpy(refills), i32(states),
                                 torch.from_numpy(freq))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy().reshape(-1)[:ns], syms)
    want = J.decode_lanes(jnp.asarray(lane_bytes), jnp.asarray(states),
                          jnp.asarray(freq), steps)
    got = P.decode_lanes(torch.from_numpy(lane_bytes), i32(states),
                         torch.from_numpy(freq), steps)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dist", DISTS + ["pad"])
@pytest.mark.parametrize("L", [0, 1, 9])
def test_decodes_on_random_u32_states(dist, L):
    """Random u32 states (0 and >= 2^31 among them: f * (x >> 12) wraps mod
    2^32, x - c may wrap, x < 2^23 is an unsigned compare), random refills,
    and random lane bytes of L per lane (L = 0: every refill reads past the
    end), on each table."""
    rng = np.random.default_rng(seed_of("random", dist, L))
    N, steps = 96, 40
    freq = tables(dist)
    states = u32_states(rng, N)
    refills = rng.integers(0, 256, (steps, N, 2), dtype=np.uint8)
    want = J.decode_lanes_aligned(jnp.asarray(refills), jnp.asarray(states),
                                  jnp.asarray(freq))
    got = P.decode_lanes_aligned(torch.from_numpy(refills), i32(states),
                                 torch.from_numpy(freq))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    lane_bytes = rng.integers(0, 256, (N, L), dtype=np.uint8)
    want = J.decode_lanes(jnp.asarray(lane_bytes), jnp.asarray(states),
                          jnp.asarray(freq), steps)
    got = P.decode_lanes(torch.from_numpy(lane_bytes), i32(states),
                         torch.from_numpy(freq), steps)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_batched_decodes_are_per_stream_decodes():
    """rans_decode_aligned / rans_decode_packed over B=3 streams of their
    own tables and states (one launch on the card) equal the reference's
    one-stream decodes; the packed twin's cursors count the bytes each lane
    consumed."""
    rng = np.random.default_rng(5)
    B, N, steps, L = 3, 32, 25, 12
    freq = np.stack([tables(d) for d in ("skewed", "peaked", "pad")])
    states = np.stack([u32_states(rng, N) for _ in range(B)])
    refills = rng.integers(0, 256, (B, steps, N, 2), dtype=np.uint8)
    lanes = rng.integers(0, 256, (B, N, L), dtype=np.uint8)
    got = P.rans_decode_aligned(torch.from_numpy(refills), i32(states),
                                torch.from_numpy(freq))
    packed, cursors = P.rans_decode_packed_ref(
        torch.from_numpy(lanes), i32(states), torch.from_numpy(freq), steps,
        cursors=True)
    assert torch.equal(packed, P.rans_decode_packed(
        torch.from_numpy(lanes), i32(states), torch.from_numpy(freq), steps))
    for b in range(B):
        args = (jnp.asarray(states[b]), jnp.asarray(freq[b]))
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(
            J.decode_lanes_aligned(jnp.asarray(refills[b]), *args)))
        np.testing.assert_array_equal(packed[b].numpy(), np.asarray(
            J.decode_lanes(jnp.asarray(lanes[b]), *args, steps)))
    assert cursors.shape == (B, N) and int(cursors.min()) >= 0
    assert int(cursors.max()) <= 2 * steps


# -- mirrors of csrc/rans_lanes.cu's arithmetic ------------------------------

M32 = 0xFFFFFFFF


def refill_select(x, b0, b1):
    """The kernels' one-select refill (numpy u64 holding u32): x < 2^15
    takes x << 16 | b0 << 8 | b1, else x < 2^23 takes x << 8 | b0, else x."""
    two = ((x << 16) | (b0 << 8) | b1) & M32
    one = ((x << 8) | b0) & M32
    return np.where(x < 2**15, two, np.where(x < P.RANS_L, one, x))


@pytest.mark.parametrize("b0,b1", [(0, 0), (255, 255), (0x5A, 0xC3),
                                   (1, 254)])
def test_one_select_refill_is_the_twins_two_refills(b0, b1):
    """For every x < 2^24 and the corners 2^15 +- 1, 2^23 +- 1, 2^31 and
    2^32 - 1: one select equals the twin's two _refill calls (the second
    refill fires only where the first left x < 2^23, which is x < 2^15)."""
    corners = np.array([2**15 - 1, 2**15, 2**15 + 1, 2**23 - 1, 2**23,
                        2**23 + 1, 2**31, 2**32 - 1], dtype=np.uint64)
    chunks = [np.arange(s, s + 2**22, dtype=np.uint64)
              for s in range(0, 2**24, 2**22)] + [corners]
    for x in chunks:
        got = refill_select(x, np.uint64(b0), np.uint64(b1))
        t = torch.from_numpy(x.astype(np.int64))
        t, _ = P._refill(t, b0)
        t, _ = P._refill(t, b1)
        np.testing.assert_array_equal(got.astype(np.int64), t.numpy())


def slot_tables(freq):
    """Mirror of the kernels' table build: each symbol marks its first slot
    cum[s], a running max over the 4096 slots gives each slot's symbol; the
    slot word is freq[s] | (slot - cum[s]) << 13 → (words u32 [4096],
    symbols u8 [4096])."""
    f = freq.astype(np.int64)
    cum = np.concatenate([[0], np.cumsum(f)])
    marks = np.zeros(P.PROB_SCALE, dtype=np.int64)
    ok = cum[:256] < P.PROB_SCALE
    marks[cum[:256][ok]] = np.arange(256)[ok]
    sym = np.maximum.accumulate(marks)
    slot = np.arange(P.PROB_SCALE)
    words = (f[sym] | (slot - cum[sym]) << 13).astype(np.uint32)
    return words, sym.astype(np.uint8)


@pytest.mark.parametrize("dist", DISTS + ["pad"])
def test_slot_tables_decode_every_slot_as_the_twin(dist):
    """Every slot, under high parts 0, random and 2^20 - 1: the mirror's
    symbol and its update x = (e & 0x1FFF) * (x >> 12) + (e >> 13) (mod
    2^32) equal _decode_symbol's, on the grid's tables and the pad row."""
    freq = tables(dist)
    words, sym = slot_tables(freq)
    assert int(words.max() & 0x1FFF) <= P.PROB_SCALE
    assert int((words >> 13).max()) < P.PROB_SCALE
    rng = np.random.default_rng(seed_of("slots", dist))
    slot = np.arange(P.PROB_SCALE, dtype=np.uint64)
    for hi in (np.zeros(P.PROB_SCALE, np.uint64),
               rng.integers(0, 2**20, P.PROB_SCALE).astype(np.uint64),
               np.full(P.PROB_SCALE, 2**20 - 1, np.uint64)):
        x = (hi << np.uint64(12)) | slot
        e = words.astype(np.uint64)
        got = ((e & np.uint64(0x1FFF)) * (x >> np.uint64(12))
               + (e >> np.uint64(13))) & np.uint64(M32)
        f, cum = P._tables(torch.from_numpy(freq)[None])
        want_s, want_x = P._decode_symbol(
            torch.from_numpy(x.astype(np.int64))[None], f, cum)
        np.testing.assert_array_equal(sym, want_s[0].numpy())
        np.testing.assert_array_equal(got.astype(np.int64), want_x[0].numpy())


@pytest.mark.parametrize("n", [1, 2, 127, 128, 129, 5000])
def test_round_trip_helpers(n):
    """roundtrip_decode and roundtrip_decode_aligned on the CPU recover the
    symbols, as the reference's do (tests/test_rans_lanes.py's short-input
    edge cases and a long stream)."""
    syms = symbols("skewed", n, seed_of("rt", n))
    freq = P.build_freq_table(syms)
    lane_bytes, states, ns = P.encode_lanes(syms, freq, 128)
    for fn in (P.roundtrip_decode, P.roundtrip_decode_aligned):
        np.testing.assert_array_equal(
            fn(lane_bytes, states, freq, ns, 128, device="cpu"), syms)
    np.testing.assert_array_equal(
        J.roundtrip_decode_aligned(lane_bytes, states, freq, ns, 128), syms)

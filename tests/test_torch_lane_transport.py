"""The port's kernels/lane_transport.py (rANS-coded tiles of the kmv_sparse
path) against jsplayer_tpu's (its host part's source text is pinned in
tests/test_torch_host_copies.py): the lockstep encoder against the
reference's encode_lanes byte for byte,
the wire bytes of both layouts, the device decode (the plain twins of
csrc/rans_lanes.cu here) on S in {0, 1, 7, 64} and after serialization,
and the malformed blobs the reference refuses (tests/test_lane_transport.py's
cases), with the same messages."""

import struct

import numpy as np
import pytest
import torch

from jsplayer_tpu.kernels import lane_transport as J
from jsplayer_tpu.kernels import rans_lanes as JR
from jsplayer_tpu_torch.kernels import lane_transport as P

torch.set_num_threads(1)


def tiles_of(seed, S, ncolors=8):
    """tests/test_lane_transport.py's tiles: S rows of 256 words from a
    palette of `ncolors` 24-bit colours."""
    rng = np.random.default_rng(seed)
    pal = rng.integers(0, 1 << 24, ncolors).astype(np.uint32)
    return pal[rng.integers(0, ncolors, (S, 256))]


@pytest.mark.parametrize("n,N,dist", [
    (0, 8, "flat"), (1, 8, "flat"), (7, 8, "skew"), (8, 8, "skew"),
    (9, 8, "one"), (1000, 128, "skew"), (4099, 512, "flat"),
    (20000, 2048, "skew"), (3000, 128, "rare"), (777, 64, "one")])
def test_encode_lanes_lockstep_matches_reference(n, N, dist):
    """The same lane bytes, states and count as the reference's
    encode_lanes: uniform bytes, a skewed palette, a single symbol, and a
    rare symbol whose 1-slot frequency emits two bytes a step."""
    rng = np.random.default_rng(n + N)
    if dist == "flat":
        syms = rng.integers(0, 256, n)
    elif dist == "skew":
        syms = rng.integers(0, 8, n) * 30 + (rng.random(n) < 0.05)
    elif dist == "one":
        syms = np.full(n, 17)
    else:
        syms = np.where(rng.random(n) < 0.002, 201, rng.integers(0, 4, n))
    syms = syms.astype(np.uint8)
    freq = JR.build_freq_table(syms)
    got = P.encode_lanes_lockstep(syms, freq, N)
    want = JR.encode_lanes(syms, freq, N)
    assert got[2] == want[2] == n
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("layout", ["packed", "aligned"])
@pytest.mark.parametrize("S", [0, 1, 7, 64])
def test_roundtrip_and_wire_bytes(layout, S):
    """encode_tiles writes the reference's wire bytes; decode_tiles_device
    (the plain twins on the CPU) recovers the tiles, as the reference's
    device decode does."""
    flat = tiles_of(S, S)
    pack = P.encode_tiles(flat, layout=layout)
    ref = J.encode_tiles(flat, layout=layout)
    assert (pack.n_tiles, pack.n_lanes) == (ref.n_tiles, ref.n_lanes)
    assert pack.wire_bytes() == ref.wire_bytes()
    assert P.pack_to_bytes(pack) == J.pack_to_bytes(ref)
    got = P.decode_tiles_device(pack, "cpu")
    assert got.dtype == torch.int32 and tuple(got.shape) == (S, 256)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), flat)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(J.decode_tiles_device(ref)))


@pytest.mark.parametrize("layout", ["packed", "aligned"])
def test_serialization_roundtrip(layout):
    flat = tiles_of(3, 19)
    blob = P.pack_to_bytes(P.encode_tiles(flat, layout=layout))
    got = P.decode_tiles_device(P.pack_from_bytes(blob), "cpu")
    np.testing.assert_array_equal(got.numpy().view(np.uint32), flat)
    assert P.pack_to_bytes(P.pack_from_bytes(blob)) == blob


def test_packed_compresses_low_entropy():
    flat = tiles_of(5, 40, ncolors=3)
    pack = P.encode_tiles(flat, layout="packed")
    assert pack.wire_bytes() < flat.size * 4 / 3


def test_top_byte_is_not_payload():
    """Pixels travel as 3 bytes: a tile word's top byte does not cross (the
    ingest masks it first, as the reference's)."""
    flat = tiles_of(9, 4) | np.uint32(0xAB000000)
    got = P.decode_tiles_device(P.encode_tiles(flat), "cpu")
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  flat & np.uint32(0x00FFFFFF))


def malformed_blobs():
    """tests/test_lane_transport.py's malformed blobs → [(what, bytes)]."""
    blob = P.pack_to_bytes(P.encode_tiles(tiles_of(1, 4)))
    out = [("magic", b"XXXX" + blob[4:]), ("header", blob[:8]),
           ("payload", blob[:-10])]
    bad = bytearray(blob)
    struct.pack_into("<I", bad, 5, 1 << 31)
    out.append(("huge S", bytes(bad)))
    bad = bytearray(blob)
    struct.pack_into("<I", bad, 9, 0)
    out.append(("zero lanes", bytes(bad)))
    return out


@pytest.mark.parametrize("what", [w for w, _ in malformed_blobs()])
def test_malformed_blobs_raise_as_the_reference(what):
    blob = dict(malformed_blobs())[what]
    msgs = []
    for mod in (J, P):
        with pytest.raises(ValueError) as e:
            mod.pack_from_bytes(blob)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_decode_never_takes_the_plain_path_off_the_cpu():
    """A pack decoded for a device other than the CPU goes to the kernel
    branch: without a card, asking for one raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the no-card path")
    with pytest.raises(RuntimeError, match="cuda"):
        P.decode_tiles_device(P.encode_tiles(tiles_of(2, 3)), "cuda")

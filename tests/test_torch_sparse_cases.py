"""SPARSE_CASES: one table of kmv_sparse_compose steps (csrc/kmv_sparse.cu),
each a shape, a layout of the planes, the tile array and the command
arrays, and a kind of tile starts, tile indices and vectors that picks a
path of the kernel.  Both sides draw from it: tests/test_torch_cuda.py
(test_sparse_kernel_cases, the kernel against its plain twin on the card)
and tests/test_torch_kmv_sparse.py (the plain twin against the JAX
package's compose_frame_kmv_sparse and ragged scan on the CPU).  The tests
here hold the table to what it claims to cover.  numpy and torch only: the
card side runs where jax is absent."""

import zlib

import numpy as np
import pytest
import torch

from test_torch_bc_cases import INT_MIN, slot_view
from test_torch_block_cases import FILL, rows_view, t32

torch.set_num_threads(1)

#: name → B, Y, X (both >= 16); and, defaults in spec():
#:   K        motion slots (2)
#:   M        tiles a frame (5)
#:   S        rows of the flat tile array (12)
#:   changed  per stream (all)
#:   layout   "contig"; "offset": prev and out start one word in (the
#:            4-byte path); "odd_stride": planes Y*X + 1 words apart;
#:            "window": prev and out are frames[:, 0] and frames[:, 1] of a
#:            [B, 3, Y, X] stack, the commands slot views of [B, 2, ...];
#:            "tiles_offset": the tile rows start one word in (the tiles'
#:            4-byte loads); "tiles_wide": tile rows 264 words apart
#:   motion   "inside": vectors in [-20, 20]; "wrap": past +-Y and +-X,
#:            near +-2^31 and -2^31 itself
#:   yx       tile starts: "grid": 16-grid block starts clamped into the
#:            frame as the host clamps edge tiles (overlapping their
#:            neighbours where Y or X % 16 != 0); "host": the host's layout,
#:            distinct blocks in raster order then pads at (0, 0); "offgrid":
#:            anywhere in [0, Y-16] x [0, X-16]; "wild": from 40 outside
#:            the frame on each side to 40 past it (a negative start
#:            counts from the end, then clamps), and +-2^31;
#:            "dup": three positions, repeated
#:   idx      tile_idx: "mixed": [-S-4, S+4) (in range, wrapping negatives,
#:            jnp.take's fill below -S and at or past S); "inside": [0, S)
#: Tile words are random u32, the top bit set in half; bcode runs over 0,
#: 1, every slot, codes past 2+K and 255; an unchanged stream's commands,
#: indices and starts are garbage.
SPARSE_CASES = {
    "edge_tiles": dict(B=2, Y=40, X=56, yx="grid", M=12),
    "edge_tiles_1080": dict(B=1, Y=1080 // 8, X=1920 // 8, yx="host",
                            M=40, S=48, idx="inside"),
    "host_layout": dict(B=3, Y=48, X=64, yx="host", M=8,
                        changed=[1, 0, 1]),
    "offgrid": dict(B=2, Y=48, X=80, yx="offgrid", M=9),
    "wild_starts": dict(B=2, Y=37, X=45, yx="wild", M=9, layout="offset"),
    "duplicates": dict(B=2, Y=32, X=64, yx="dup", M=10),
    "wrapping": dict(B=4, Y=56, X=80, motion="wrap", changed=[1, 1, 0, 1]),
    "odd_wrapping": dict(B=2, Y=37, X=45, motion="wrap", yx="offgrid"),
    "m1": dict(B=2, Y=32, X=64, M=1, yx="offgrid"),
    "m_nb": dict(B=2, Y=40, X=72, yx="host", M=15, S=20, idx="inside"),
    "k0": dict(B=2, Y=48, X=80, K=0, yx="grid"),
    "k8": dict(B=3, Y=48, X=80, K=8, changed=[1, 0, 1]),
    "unchanged_garbage": dict(B=3, Y=32, X=128, changed=[0, 1, 0]),
    "odd_stride": dict(B=2, Y=48, X=128, layout="odd_stride", yx="grid"),
    "window_view": dict(B=2, Y=32, X=256, layout="window", yx="host", M=12),
    "tiles_offset": dict(B=2, Y=48, X=64, layout="tiles_offset", yx="grid"),
    "tiles_wide": dict(B=2, Y=48, X=64, layout="tiles_wide", yx="host"),
    "x_not_4": dict(B=2, Y=48, X=70, yx="offgrid", M=8),
    "b5": dict(B=5, Y=32, X=64, changed=[1, 0, 1, 1, 0], yx="dup"),
    # steps of one shape that SPARSE_SEQUENCES runs one after another
    "seq_many": dict(B=2, Y=40, X=56, yx="offgrid", M=12, idx="inside"),
    "seq_few": dict(B=2, Y=40, X=56, yx="grid", M=2),
    "seq_none": dict(B=2, Y=40, X=56, M=0),
    "seq_unchanged": dict(B=2, Y=40, X=56, yx="offgrid", M=6,
                          changed=[1, 0]),
}

#: name → SPARSE_CASES steps of one shape run in order on one device: the
#: kernel's per-cell scratch, kept from call to call, must be clean at
#: every call (tests/test_torch_cuda.py test_sparse_kernel_sequences)
SPARSE_SEQUENCES = {
    "fewer_tiles": ("seq_many", "seq_few"),
    "m0_after_tiles": ("seq_many", "seq_none"),
    "unchanged_after_tiles": ("seq_many", "seq_unchanged", "seq_few"),
}


def spec(name):
    c = dict(K=2, M=5, S=12, changed=None, layout="contig", motion="inside",
             yx="grid", idx="mixed")
    c.update(SPARSE_CASES[name])
    if c["changed"] is None:
        c["changed"] = [1] * c["B"]
    return c


def grid(Y, X):
    return (Y + 15) // 16, (X + 15) // 16


def tile_starts(c, rng):
    """tile_yx [B, M, 2] of the case's kind (see SPARSE_CASES)."""
    B, Y, X, M = c["B"], c["Y"], c["X"], c["M"]
    nby, nbx = grid(Y, X)
    kind = c["yx"]
    yx = np.zeros((B, M, 2), dtype=np.int64)
    for b in range(B):
        if kind in ("grid", "host", "dup"):
            if kind == "host":
                n = min(M, nby * nbx) if M == nby * nbx else \
                    int(rng.integers(1, M))
                blocks = np.sort(rng.choice(nby * nbx, n, replace=False))
            elif kind == "dup":
                blocks = rng.choice(rng.choice(nby * nbx, 3, replace=False),
                                    M)
            else:
                blocks = rng.integers(0, nby * nbx, M)
            by, bx = np.divmod(blocks, nbx)
            yx[b, : len(blocks), 0] = np.minimum(by * 16, Y - 16)
            yx[b, : len(blocks), 1] = np.minimum(bx * 16, X - 16)
        elif kind == "offgrid":
            yx[b, :, 0] = rng.integers(0, Y - 15, M)
            yx[b, :, 1] = rng.integers(0, X - 15, M)
        else:  # wild
            yx[b, :, 0] = rng.integers(-40, Y + 40, M)
            yx[b, :, 1] = rng.integers(-40, X + 40, M)
            yx[b, 0] = (INT_MIN, 2**31 - 1)
    return yx


def case_inputs(name):
    """numpy inputs of the case → (prev u32 [B, Y, X], bcode u8 [B, NB],
    mvk int32 [B, K, 2], tiles u32 [S, 256], tile_idx int32 [B, M],
    tile_yx int32 [B, M, 2], changed [B] bool), made from a seed the name
    gives."""
    c = spec(name)
    rng = np.random.default_rng(zlib.crc32(("sparse:" + name).encode()))
    B, Y, X, K, M, S = (c[k] for k in ("B", "Y", "X", "K", "M", "S"))
    nb = grid(Y, X)[0] * grid(Y, X)[1]
    bcode = rng.integers(0, K + 4, (B, nb))
    bcode = np.where(rng.random((B, nb)) < 0.05, 255, bcode)
    if c["motion"] == "wrap":
        mvk = np.stack([rng.integers(X, 3 * X, (B, K)),
                        rng.integers(Y, 3 * Y, (B, K))], -1)
        mvk *= rng.choice([-1, 1], mvk.shape)
        extremes = np.array([2**31 - 9, -(2**31) + 5, INT_MIN, -1])
        mvk = np.where(rng.random(mvk.shape) < 0.4,
                       rng.choice(extremes, mvk.shape), mvk)
    else:
        mvk = rng.integers(-20, 21, (B, K, 2))
    tiles = rng.integers(0, 1 << 32, (S, 256), dtype=np.uint32)
    lo, hi = (0, S) if c["idx"] == "inside" else (-S - 4, S + 4)
    idx = rng.integers(lo, hi, (B, M))
    yx = tile_starts(c, rng)
    chg = np.array(c["changed"], dtype=bool)
    for b in np.nonzero(~chg)[0]:  # garbage an unchanged stream never reads
        bcode[b] = rng.integers(0, 256, nb)
        mvk[b] = rng.integers(-(2**31), 2**31, (K, 2))
        idx[b] = rng.integers(-(2**31), 2**31, M)
        yx[b] = rng.integers(-(2**31), 2**31, (M, 2))
    prev = rng.integers(0, 1 << 32, (B, Y, X), dtype=np.uint32)
    return (prev, bcode.astype(np.uint8), mvk.astype(np.int32), tiles,
            idx.astype(np.int32), yx.astype(np.int32), chg)


def sparse_case(name):
    """The case's step as contiguous CPU tensors → (prev, [bcode, mvk,
    tiles, tile_idx, tile_yx], changed)."""
    prev, bcode, mvk, tiles, idx, yx, chg = case_inputs(name)
    return (t32(prev), [torch.from_numpy(bcode), torch.from_numpy(mvk),
                        t32(tiles), torch.from_numpy(idx),
                        torch.from_numpy(yx)], torch.from_numpy(chg))


def tile_rows(t, offset=0, row_stride=256):
    """A copy of tiles t [S, 256] in a fresh buffer: rows `row_stride`
    words apart, the first `offset` words in."""
    S = t.shape[0]
    buf = torch.full((offset + S * row_stride + 256,), 0x5A5A5A5A,
                     dtype=torch.int32, device=t.device)
    v = torch.as_strided(buf, (S, 256), (row_stride, 1), offset)
    v.copy_(t)
    return v


def case_layout(name, prev, args):
    """prev and args in the case's layout on their device, and an `out` of
    that layout filled with FILL → (prev, args, out, stack): stack is the
    window layout's [B, 3, Y, X] frames (prev at slot 0, out at 1, slot 2
    untouched), else None."""
    layout = spec(name)["layout"]
    bcode, mvk, tiles, idx, yx = (a.clone() for a in args)
    fill = torch.full_like(prev, FILL)
    if layout == "window":
        B, Y, X = prev.shape
        stack = torch.full((B, 3, Y, X), FILL, dtype=torch.int32,
                           device=prev.device)
        stack[:, 0] = prev
        return (stack[:, 0], [slot_view(bcode), slot_view(mvk), tiles,
                              slot_view(idx), slot_view(yx)],
                stack[:, 1], stack)
    if layout in ("contig", "tiles_offset", "tiles_wide"):
        if layout != "contig":
            tiles = tile_rows(tiles, *{"tiles_offset": (1, 256),
                                       "tiles_wide": (0, 264)}[layout])
        return prev.clone(), [bcode, mvk, tiles, idx, yx], fill, None
    offset, pad = {"offset": (1, 0), "odd_stride": (0, 1)}[layout]
    return (rows_view(prev, offset, pad), [bcode, mvk, tiles, idx, yx],
            rows_view(fill, offset, pad), None)


def run_sparse_case(name, device):
    """kmv_sparse_compose on the case, in the case's layout on `device` →
    (prev, args, changed as made on the CPU, out on the CPU).  Checks that
    the wrapper wrote only its slot and counted its launch (one on the
    card, none for CPU tensors)."""
    from jsplayer_tpu_torch.kernels.sp_recon import kmv_sparse_compose

    prev, args, chg = sparse_case(name)
    pv, dev_args, out, stack = case_layout(
        name, prev.to(device), [a.to(device) for a in args])
    before = kmv_sparse_compose.launches
    got = kmv_sparse_compose(pv, *dev_args, chg.to(device), out=out)
    assert got.data_ptr() == out.data_ptr()
    assert kmv_sparse_compose.launches == before + (
        torch.device(device).type == "cuda")
    if stack is not None:
        assert torch.equal(stack[:, 0].cpu(), prev)
        assert (stack[:, 2] == FILL).all()
    return prev, args, chg, out.cpu()


def owner_cells(name):
    """For each changed stream's block cell: (top, full, partial), the
    largest tile that touches the cell, the largest that covers its whole
    in-frame part (-1: none) and the count of tiles that cover part of it,
    as csrc/kmv_sparse.cu's owner pass computes them → list of [NB, 3]
    arrays."""
    from jsplayer_tpu_torch.kernels.sp_recon import tile_start

    c = spec(name)
    Y, X = c["Y"], c["X"]
    nby, nbx = grid(Y, X)
    _, _, _, _, _, yx, chg = case_inputs(name)
    out = []
    for b in np.nonzero(chg)[0]:
        cells = np.full((nby * nbx, 3), -1)
        cells[:, 2] = 0
        for m, (ty, tx) in enumerate(yx[b].tolist()):
            y0, x0 = tile_start(ty, Y), tile_start(tx, X)
            for cy in range(y0 >> 4, ((y0 + 15) >> 4) + 1):
                for cx in range(x0 >> 4, ((x0 + 15) >> 4) + 1):
                    i = cy * nbx + cx
                    cells[i, 0] = m
                    if (y0 <= cy * 16 and y0 + 16 >= min(cy * 16 + 16, Y)
                            and x0 <= cx * 16
                            and x0 + 16 >= min(cx * 16 + 16, X)):
                        cells[i, 1] = m
                    else:
                        cells[i, 2] += 1
        out.append(cells)
    return out


def vector_path(prev, out):
    """Whether the compose takes its 16-byte path for these planes: X % 4
    == 0, 16-byte aligned bases, batch strides a multiple of 4 words."""
    return all(t.shape[-1] % 4 == 0 and t.data_ptr() % 16 == 0
               and t.stride(0) % 4 == 0 for t in (prev, out))


# -- the table covers what it claims -----------------------------------------

@pytest.mark.parametrize("name", sorted(SPARSE_CASES))
def test_sparse_case_picks_its_kernel_path(name):
    """The 16-byte path runs where X % 4 == 0 in every layout but offset
    and odd_stride; tiles take 16-byte loads where their rows are 4-word
    aligned (every layout but tiles_offset)."""
    c = spec(name)
    prev, args, _ = sparse_case(name)
    pv, (_, _, tiles, _, _), out, _ = case_layout(name, prev, args)
    assert vector_path(pv, out) == (c["X"] % 4 == 0 and c["layout"] not in (
        "offset", "odd_stride"))
    assert (tiles.data_ptr() % 16 == 0 and tiles.stride(0) % 4 == 0) == (
        c["layout"] != "tiles_offset")


def test_sparse_cases_cover_shapes_and_layouts():
    specs = [spec(n) for n in SPARSE_CASES]
    for what, claim in (
            ("x_not_4", lambda c: c["X"] % 4 != 0),
            ("odd_y_and_x", lambda c: c["Y"] % 2 == 1 and c["X"] % 2 == 1),
            ("y_not_16", lambda c: c["Y"] % 16 != 0),
            ("x_not_16", lambda c: c["X"] % 16 != 0),
            ("offset_base", lambda c: c["layout"] == "offset"),
            ("odd_batch_stride", lambda c: c["layout"] == "odd_stride"),
            ("window_view", lambda c: c["layout"] == "window"),
            ("tiles_offset", lambda c: c["layout"] == "tiles_offset"),
            ("tiles_wide", lambda c: c["layout"] == "tiles_wide"),
            ("m0", lambda c: c["M"] == 0),
            ("m1", lambda c: c["M"] == 1),
            ("m_nb", lambda c: c["M"] == np.prod(grid(c["Y"], c["X"]))),
            ("b1", lambda c: c["B"] == 1),
            ("b5", lambda c: c["B"] == 5),
            ("k0", lambda c: c["K"] == 0),
            ("k8", lambda c: c["K"] == 8),
            ("unchanged", lambda c: not all(c["changed"]))):
        assert any(claim(c) for c in specs), what


def test_sparse_sequences_reuse_one_shape():
    """Each sequence's steps share B, Y and X (so the same cells of the
    scratch are read again), and the sequences hold what their names say:
    fewer tiles after more, M = 0 after tiles, and a stream that had tiles,
    then is unchanged, then changes again."""
    for seq, steps in SPARSE_SEQUENCES.items():
        specs = [spec(n) for n in steps]
        assert len({(c["B"], c["Y"], c["X"]) for c in specs}) == 1, seq
    many, few = (spec(n) for n in SPARSE_SEQUENCES["fewer_tiles"])
    assert many["M"] > few["M"] > 0
    assert [spec(n)["M"] for n in SPARSE_SEQUENCES["m0_after_tiles"]] == [
        many["M"], 0]
    steps = [spec(n) for n in SPARSE_SEQUENCES["unchanged_after_tiles"]]
    assert [c["changed"][1] for c in steps] == [1, 0, 1]
    assert steps[0]["M"] > 0


def test_cell_scratch_is_kept_clean_and_grows():
    """The wrapper's scratch: every header -1, kept for each (device,
    stream) and handed out again while it is large enough, a larger one
    when not, with the smaller one still held (a captured graph may hold its
    pointer); another stream gets its own; after a failed launch the same
    storage is refilled."""
    from jsplayer_tpu_torch.kernels import sp_recon as P

    dev = torch.device("cpu")
    keys = [(dev, 1), (dev, 2)]
    for key in keys:
        P._CELLS.pop(key, None)
        P._REFILL.discard(key)
    try:
        a = P.cell_scratch(dev, 1, 5)
        assert a.shape == (5, 8) and bool((a == -1).all())
        assert P.cell_scratch(dev, 1, 3) is a
        b = P.cell_scratch(dev, 1, 9)
        assert b.shape == (9, 8) and bool((b == -1).all())
        assert P._CELLS[(dev, 1)] == [a, b]
        other = P.cell_scratch(dev, 2, 3)
        assert other is not b and P._CELLS[(dev, 2)] == [other]
        b[:, 0] = 7  # headers a failed launch left set
        P._REFILL.add((dev, 1))
        assert P.cell_scratch(dev, 1, 9) is b and bool((b == -1).all())
        assert (dev, 1) not in P._REFILL
    finally:
        for key in keys:
            P._CELLS.pop(key, None)
            P._REFILL.discard(key)


def test_sparse_cases_hold_every_code_index_start_and_vector():
    """In changed streams: codes 0, 1, every motion slot, codes >= 2+K and
    255; indices in [0, S), wrapping ones in [-S, -1], ones below -S and at
    or past S; starts below 0 and past Y-16 or X-16 (clamped), off the
    16-grid, repeated; tile words with the top bit set; vectors negative,
    >= Y or X, near +-2^31 and -2^31 itself; and block cells where a later
    tile covers only part of the cell after the last one that covers all
    of it: cells whose partial tiles fit the kernel's list of four, and
    cells whose list overflows (the kernel's walk); and cells that no tile
    touches."""
    seen = dict(copy=0, data=0, motion=0, past_k=0, code255=0, inside=0,
                wrap=0, below=0, past=0, neg_start=0, big_start=0,
                off_grid=0, repeated=0, top_bit=0, neg=0, big=0, near31=0,
                int_min=0, listed=0, overflow=0, untouched=0)
    for name in SPARSE_CASES:
        c = spec(name)
        _, bcode, mvk, tiles, idx, yx, chg = case_inputs(name)
        K, S, Y, X = c["K"], c["S"], c["Y"], c["X"]
        bcode, mvk, idx, yx = bcode[chg], mvk[chg], idx[chg], yx[chg]
        seen["copy"] += int((bcode == 0).sum())
        seen["data"] += int((bcode == 1).sum())
        seen["motion"] += int(((bcode >= 2) & (bcode < 2 + K)).sum())
        seen["past_k"] += int(((bcode >= 2 + K) & (bcode < 255)).sum())
        seen["code255"] += int((bcode == 255).sum())
        seen["inside"] += int(((idx >= 0) & (idx < S)).sum())
        seen["wrap"] += int(((idx >= -S) & (idx < 0)).sum())
        seen["below"] += int((idx < -S).sum())
        seen["past"] += int((idx >= S).sum())
        seen["neg_start"] += int((yx < 0).sum())
        seen["big_start"] += int(((yx[..., 0] > Y - 16)
                                  | (yx[..., 1] > X - 16)).sum())
        y0 = np.where(yx[..., 0] < 0, yx[..., 0] + Y, yx[..., 0]).clip(0, Y - 16)
        x0 = np.where(yx[..., 1] < 0, yx[..., 1] + X, yx[..., 1]).clip(0, X - 16)
        seen["off_grid"] += int(((y0 % 16 != 0) | (x0 % 16 != 0)).sum())
        for b in range(len(yx)):
            pos = [tuple(p) for p in yx[b].tolist()]
            seen["repeated"] += len(pos) - len(set(pos))
        seen["top_bit"] += int((tiles >> 31 != 0).sum())
        m = mvk.astype(np.int64)
        seen["neg"] += int((m < 0).sum())
        seen["big"] += int(((np.abs(m[..., 0]) >= X)
                            | (np.abs(m[..., 1]) >= Y)).sum())
        seen["near31"] += int((np.abs(m) > 2**31 - 10).sum())
        seen["int_min"] += int((m == INT_MIN).sum())
        for cells in owner_cells(name):
            later = cells[:, 0] > cells[:, 1]
            seen["listed"] += int((later & (cells[:, 2] <= 4)).sum())
            seen["overflow"] += int((later & (cells[:, 2] > 4)).sum())
            seen["untouched"] += int((cells[:, 0] < 0).sum())
    assert all(v > 0 for v in seen.values()), seen


def test_edge_tiles_overlap_their_neighbours():
    """The host's clamped edge tiles (Y or X not a multiple of 16) cover
    part of the cell before them: the cells the kernel resolves from its
    list of partial tiles."""
    for name in ("edge_tiles", "edge_tiles_1080", "m_nb"):
        assert spec(name)["Y"] % 16 or spec(name)["X"] % 16
        assert any((cells[:, 0] > cells[:, 1]).any()
                   for cells in owner_cells(name)), name


@pytest.mark.parametrize("name", sorted(SPARSE_CASES))
def test_sparse_case_runs_on_the_cpu_as_its_plain_twin(name):
    """On CPU tensors kmv_sparse_compose is its plain twin, written into the
    case's strided out and counting no launch."""
    from jsplayer_tpu_torch.kernels.sp_recon import kmv_sparse_compose_ref

    prev, args, chg, got = run_sparse_case(name, "cpu")
    assert torch.equal(got, kmv_sparse_compose_ref(prev, *args, chg))

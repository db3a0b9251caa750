"""LANE_CASES: one table of lane_compose steps (csrc/bc_compose.cu's lane
instance), each a shape, a layout of the planes, rows and command arrays,
and a kind of commands and row indices that picks a path of the kernel.
Both sides draw from it: tests/test_torch_cuda.py (test_lane_kernel_cases,
the kernel against its plain twin on the card) and
tests/test_torch_lane_recon.py (the plain twin against the JAX package's
compose_frame_lane on the CPU).  The tests here hold the table to what it
claims to cover.  numpy and torch only: the card side runs where jax is
absent."""

import zlib

import numpy as np
import pytest
import torch

from test_torch_bc_cases import INT_MIN, bytes_view, commands_of, slot_view
from test_torch_block_cases import FILL, rows_view, t32

torch.set_num_threads(1)

#: name → B, Y, X; K, changed, layout, motion and rects as in BC_CASES
#: (test_torch_bc_cases.py), and
#:   Ur    rows of the window's row table (default 6)
#:   rows  "contig": rows [B, Ur, X]; "wide": the [:, :, :X] view of
#:         [B, Ur, ncol*128] rows (the ingest's layout); "odd": rows X + 1
#:         words apart (the 4-byte path)
#:   idx   "mixed": row_idx over [-Ur-4, Ur+4): in range, wrapping
#:         negatives and indices outside [-Ur, Ur) on both sides (jnp.take
#:         reads 0xFFFFFFFF there); "inside": [0, Ur)
#: In the "offset" layout the rows start one word in as well.  Rows hold
#: random u32 words, their top byte set in most (no 0xFFFFFF mask applies);
#: an unchanged stream's row_idx is garbage.
LANE_CASES = {
    "x_not_4": dict(B=3, Y=48, X=70, changed=[1, 0, 1]),
    "odd_y_x": dict(B=2, Y=33, X=71),
    "y_not_16": dict(B=2, Y=40, X=128),
    "offset_base": dict(B=3, Y=32, X=128, layout="offset",
                        changed=[1, 1, 0]),
    "odd_stride": dict(B=2, Y=48, X=128, layout="odd_stride"),
    "window_view": dict(B=2, Y=32, X=256, layout="window"),
    "rloc_bytes": dict(B=2, Y=32, X=128, layout="rloc_bytes"),
    "wide_rows": dict(B=3, Y=48, X=200, rows="wide"),
    "odd_row_stride": dict(B=2, Y=32, X=128, rows="odd"),
    "full_rects_mx4": dict(B=2, Y=48, X=128, rects="full", motion="mx4"),
    "split_rects": dict(B=2, Y=32, X=128, rects="split"),
    "wrapping": dict(B=4, Y=56, X=80, motion="wrap", changed=[1, 1, 0, 1]),
    "odd_wrapping": dict(B=2, Y=37, X=45, motion="wrap", layout="offset"),
    "k0": dict(B=2, Y=48, X=80, K=0),
    "k8": dict(B=3, Y=48, X=80, K=8, changed=[1, 0, 1]),
    "unchanged_garbage": dict(B=3, Y=32, X=128, changed=[0, 1, 0]),
    "b1_ur1": dict(B=1, Y=32, X=128, Ur=1),
    "b5": dict(B=5, Y=32, X=128, changed=[1, 0, 1, 1, 0]),
    "rows_inside": dict(B=2, Y=64, X=256, rects="full", idx="inside",
                        rows="wide"),
}


def spec(name):
    c = dict(K=2, changed=None, layout="contig", motion="inside",
             rects="random", Ur=6, rows="contig", idx="mixed")
    c.update(LANE_CASES[name])
    if c["changed"] is None:
        c["changed"] = [1] * c["B"]
    return c


def case_inputs(name):
    """numpy inputs of the case → (prev u32 [B, Y, X], rows u32 [B, Ur, X],
    row_idx int32 [B, Y], bcode u8 [B, NB], rloc u8 [B, NB, 4], mvk int32
    [B, K, 2], changed [B] bool), made from a seed the name gives."""
    c = spec(name)
    rng = np.random.default_rng(zlib.crc32(("lane:" + name).encode()))
    prev, _, bcode, rloc, mvk, chg = commands_of(c, rng)
    B, Y, X, Ur = c["B"], c["Y"], c["X"], c["Ur"]
    rows = rng.integers(0, 1 << 32, (B, Ur, X), dtype=np.uint32)
    lo, hi = (0, Ur) if c["idx"] == "inside" else (-Ur - 4, Ur + 4)
    row_idx = rng.integers(lo, hi, (B, Y))
    for b in np.nonzero(~chg)[0]:  # garbage an unchanged stream never reads
        row_idx[b] = rng.integers(-(2**31), 2**31, Y)
    return (prev, rows, row_idx.astype(np.int32), bcode, rloc, mvk, chg)


def lane_case(name):
    """The case's step as contiguous CPU tensors → (prev, [rows, row_idx,
    bcode, rloc, mvk], changed)."""
    prev, rows, row_idx, bcode, rloc, mvk, chg = case_inputs(name)
    return (t32(prev), [t32(rows), torch.from_numpy(row_idx),
                        torch.from_numpy(bcode), torch.from_numpy(rloc),
                        torch.from_numpy(mvk)], torch.from_numpy(chg))


def strided_rows(t, offset=0, row_stride=None):
    """A copy of rows t [B, Ur, X] in a fresh buffer: rows `row_stride`
    words apart (X by default), the first row `offset` words in."""
    B, Ur, X = t.shape
    rs = X if row_stride is None else row_stride
    buf = torch.full((offset + B * Ur * rs + rs,), 0x5A5A5A5A,
                     dtype=torch.int32, device=t.device)
    v = torch.as_strided(buf, (B, Ur, X), (Ur * rs, rs, 1), offset)
    v.copy_(t)
    return v


def case_layout(name, prev, args):
    """prev and args in the case's layout on their device, and an `out` of
    that layout filled with FILL → (prev, args, out, stack): stack is the
    window layout's [B, 3, Y, X] frames (prev at slot 0, out at 1, slot 2
    untouched), else None."""
    c = spec(name)
    rows, row_idx, bcode, rloc, mvk = args
    X = c["X"]
    rows = {"contig": lambda: rows.clone(),
            "wide": lambda: strided_rows(rows, 0, -(-X // 128) * 128),
            "odd": lambda: strided_rows(rows, 0, X + 1)}[c["rows"]]()
    args = [rows, row_idx.clone(), bcode.clone(), rloc.clone(), mvk.clone()]
    layout = c["layout"]
    fill = torch.full_like(prev, FILL)
    if layout == "window":
        B, Y, X = prev.shape
        stack = torch.full((B, 3, Y, X), FILL, dtype=torch.int32,
                           device=prev.device)
        stack[:, 0] = prev
        return (stack[:, 0], [slot_view(a) for a in args], stack[:, 1],
                stack)
    if layout == "rloc_bytes":
        args[3] = bytes_view(rloc)
        return prev.clone(), args, fill, None
    if layout == "contig":
        return prev.clone(), args, fill, None
    offset, pad = {"offset": (1, 0), "odd_stride": (0, 1)}[layout]
    if offset:
        args[0] = strided_rows(rows, offset, rows.stride(1))
    return (rows_view(prev, offset, pad), args, rows_view(fill, offset, pad),
            None)


def run_lane_case(name, device):
    """lane_compose on the case, in the case's layout on `device` → (prev,
    args, changed as made on the CPU, out on the CPU).  Checks that the
    wrapper wrote only its slot and counted its launch (one on the card,
    none for CPU tensors)."""
    from jsplayer_tpu_torch.kernels.lane_recon import lane_compose

    prev, args, chg = lane_case(name)
    pv, dev_args, out, stack = case_layout(
        name, prev.to(device), [a.to(device) for a in args])
    before = lane_compose.launches
    got = lane_compose(pv, *dev_args, chg.to(device), out=out)
    assert got.data_ptr() == out.data_ptr()
    assert lane_compose.launches == before + (torch.device(device).type ==
                                              "cuda")
    if stack is not None:
        assert torch.equal(stack[:, 0].cpu(), prev)
        assert (stack[:, 2] == FILL).all()
    return prev, args, chg, out.cpu()


def vector_path(prev, rows, out):
    """Whether the lane instance takes its 16-byte path for these planes:
    X % 4 == 0, 16-byte aligned bases, batch and row strides a multiple of
    4 words."""
    return all(t.shape[-1] % 4 == 0 and t.data_ptr() % 16 == 0
               and t.stride(0) % 4 == 0 and t.stride(1) % 4 == 0
               for t in (prev, rows, out))


# -- the table covers what it claims -----------------------------------------

@pytest.mark.parametrize("name", sorted(LANE_CASES))
def test_lane_case_picks_its_kernel_path(name):
    """The 16-byte path runs where X % 4 == 0 in the contiguous, window and
    rloc_bytes layouts with rows 4-word aligned ("contig" or "wide"); the
    offset and odd-stride layouts, odd row strides and X % 4 != 0 take the
    4-byte path."""
    c = spec(name)
    prev, args, _ = lane_case(name)
    pv, (rows, *_), out, _ = case_layout(name, prev, args)
    want = (c["X"] % 4 == 0 and c["rows"] != "odd"
            and c["layout"] in ("contig", "window", "rloc_bytes"))
    assert vector_path(pv, rows, out) == want


def test_lane_cases_cover_shapes_and_layouts():
    """BC_CASES' shapes and layouts, plus the ingest's wide rows, an odd row
    stride, Ur = 1 and in-range-only indices."""
    specs = [spec(n) for n in LANE_CASES]
    for what, claim in (
            ("x_not_4", lambda c: c["X"] % 4 != 0),
            ("odd_y_and_x", lambda c: c["Y"] % 2 == 1 and c["X"] % 2 == 1),
            ("y_not_16", lambda c: c["Y"] % 16 != 0),
            ("offset_base", lambda c: c["layout"] == "offset"),
            ("odd_batch_stride", lambda c: c["layout"] == "odd_stride"),
            ("window_view", lambda c: c["layout"] == "window"),
            ("rloc_bytes", lambda c: c["layout"] == "rloc_bytes"),
            ("wide_rows", lambda c: c["rows"] == "wide"),
            ("odd_rows", lambda c: c["rows"] == "odd"),
            ("ur1", lambda c: c["Ur"] == 1),
            ("inside_only", lambda c: c["idx"] == "inside"),
            ("b1", lambda c: c["B"] == 1),
            ("b5", lambda c: c["B"] == 5),
            ("k0", lambda c: c["K"] == 0),
            ("k8", lambda c: c["K"] == 8),
            ("unchanged", lambda c: not all(c["changed"]))):
        assert any(claim(c) for c in specs), what


def test_lane_cases_hold_every_index_code_rect_and_vector():
    """In changed streams, on data rows (a code-1 block with a row inside
    its rect): indices in [0, Ur), wrapping ones in [-Ur, -1], and ones below
    -Ur and at or past Ur; rows words with the top byte set; codes 0, 1,
    every motion slot, codes >= 2+K and 255; vectors that are negative,
    >= Y or X, near +-2^31 and -2^31 itself."""
    seen = dict(inside=0, wrap=0, below=0, past=0, top_byte=0, copy=0,
                motion=0, past_k=0, code255=0, neg=0, big=0, near31=0,
                int_min=0)
    for name in LANE_CASES:
        c = spec(name)
        _, rows, row_idx, bcode, rloc, mvk, chg = case_inputs(name)
        K, Ur = c["K"], c["Ur"]
        bcode, rloc, mvk, ri = bcode[chg], rloc[chg], mvk[chg], row_idx[chg]
        data = bcode == 1
        dy = np.zeros(ri.shape, dtype=bool)  # rows some data rect covers
        nbx = (c["X"] + 15) // 16
        for b, i in zip(*np.nonzero(data & (rloc[..., 2] > rloc[..., 0]))):
            y0 = (i // nbx) * 16
            dy[b, y0 + rloc[b, i, 1]: y0 + min(16, rloc[b, i, 3])] = True
        d = ri[dy]
        seen["inside"] += int(((d >= 0) & (d < Ur)).sum())
        seen["wrap"] += int(((d >= -Ur) & (d < 0)).sum())
        seen["below"] += int((d < -Ur).sum())
        seen["past"] += int((d >= Ur).sum())
        seen["top_byte"] += int((rows[chg] >> 24 != 0).sum())
        seen["copy"] += int((bcode == 0).sum())
        seen["motion"] += int(((bcode >= 2) & (bcode < 2 + K)).sum())
        seen["past_k"] += int(((bcode >= 2 + K) & (bcode < 255)).sum())
        seen["code255"] += int((bcode == 255).sum())
        m = mvk.astype(np.int64)
        seen["neg"] += int((m < 0).sum())
        seen["big"] += int(((np.abs(m[..., 0]) >= c["X"])
                            | (np.abs(m[..., 1]) >= c["Y"])).sum())
        seen["near31"] += int((np.abs(m) > 2**31 - 10).sum())
        seen["int_min"] += int((m == INT_MIN).sum())
    assert all(v > 0 for v in seen.values()), seen


@pytest.mark.parametrize("name", sorted(LANE_CASES))
def test_lane_case_runs_on_the_cpu_as_its_plain_twin(name):
    """On CPU tensors lane_compose is its plain twin, written into the
    case's strided out and counting no launch."""
    from jsplayer_tpu_torch.kernels.lane_recon import lane_compose_ref

    prev, args, chg, got = run_lane_case(name, "cpu")
    assert torch.equal(got, lane_compose_ref(prev, *args, chg))

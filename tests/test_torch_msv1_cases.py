"""MSV1_CASES: one table of msv1_paint windows (csrc/msv1_paint.cu), each a
shape, a layout of the frames and commands, and a kind of commands that
picks a path of the kernel.  Both sides draw from it:
tests/test_torch_cuda.py (test_msv1_kernel_cases, the kernel against its
plain twin on the card) and tests/test_torch_msv1.py (the plain twin
against the JAX package's decode_batch on the CPU).  The tests here hold
the table to what it claims to cover.  numpy and torch only: the card side
runs where jax is absent."""

import os
import re
import zlib

import numpy as np
import pytest
import torch

from test_torch_block_cases import FILL, t32

torch.set_num_threads(1)

#: name → B, T, Y, X (multiples of 4); and, defaults in spec():
#:   insign  insignificant lines (0)
#:   layout  "contig"; "offset": init, frames, colours and sel start one
#:           element in (the kernel's scalar loads and stores); "slice":
#:           the window is steps [1, 1+T) of [B, T+2, ...] commands and
#:           frames (strided views, slots around it untouched)
#:   cmds    "random": btype 0-3, sel 0-15 (>= 8 keeps the pixel), random
#:           u32 colours; "all": every block painted with sel < 8; "none":
#:           nothing painted; "high": every block painted, every sel >= 8
#: changes and init_valid are random; colours and init have the top bit set
#: in half their words.  The staged instance copies sel and colours RING
#: steps ahead (its ring's depth) and flushes a diff mask every FLUSH steps:
#: T around both picks its edges; X = 352 (CIF) and 320 tile its warps of 8
#: MSV1 blocks exactly, X = 36, 20 and 520 leave part of the last warp out.
RING, FLUSH = 4, 64
MSV1_CASES = {
    "random": dict(B=2, T=5, Y=48, X=64),
    "narrow": dict(B=3, T=4, Y=20, X=36),
    "wide_rows": dict(B=1, T=3, Y=24, X=520, insign=9),
    "insign_lines": dict(B=2, T=6, Y=32, X=64, insign=13),
    "offset": dict(B=2, T=4, Y=28, X=44, layout="offset"),
    "slice": dict(B=2, T=4, Y=32, X=48, layout="slice"),
    "all_painted": dict(B=2, T=3, Y=16, X=32, cmds="all"),
    "none_painted": dict(B=2, T=3, Y=16, X=32, cmds="none"),
    "sel_high": dict(B=2, T=3, Y=16, X=32, cmds="high"),
    "b1_t1": dict(B=1, T=1, Y=8, X=8),
    "b5": dict(B=5, T=2, Y=12, X=20, insign=4),
    "ring_under": dict(B=2, T=RING - 1, Y=8, X=64),
    "ring_depth": dict(B=2, T=RING, Y=12, X=32, insign=5),
    "ring_over": dict(B=2, T=RING + 1, Y=8, X=96),
    "flush_t64": dict(B=2, T=FLUSH, Y=8, X=32, insign=2),
    "flush_t65": dict(B=2, T=FLUSH + 1, Y=8, X=48),
    "flush_t130": dict(B=1, T=2 * FLUSH + 2, Y=8, X=32, insign=3),
    "cif_width": dict(B=2, T=6, Y=8, X=352, insign=1),
    "qvga_width": dict(B=2, T=5, Y=12, X=320),
    "all_painted_long": dict(B=2, T=FLUSH + 6, Y=16, X=64, cmds="all"),
    "insign_last_row": dict(B=2, T=6, Y=16, X=64, insign=15),
    "slice_long": dict(B=2, T=FLUSH + 3, Y=8, X=32, layout="slice"),
}


def spec(name):
    c = dict(insign=0, layout="contig", cmds="random")
    c.update(MSV1_CASES[name])
    return c


def case_inputs(name):
    """numpy inputs of the case → (init u32 [B, Y, X], btype u8 [B, T, NB],
    sel u8 [B, T, Y, X] (plane order), colors u32 [B, T, NB, 8], changes
    [B, T] bool, init_valid [B] bool, insign_lines)."""
    c = spec(name)
    rng = np.random.default_rng(zlib.crc32(("msv1:" + name).encode()))
    B, T, Y, X = c["B"], c["T"], c["Y"], c["X"]
    nb = (Y // 4) * (X // 4)
    init = rng.integers(0, 1 << 32, (B, Y, X), dtype=np.uint32)
    btype = rng.integers(0, 4, (B, T, nb))
    sel = rng.integers(0, 16, (B, T, Y, X))
    if c["cmds"] == "all":
        btype = rng.integers(1, 4, (B, T, nb))
        sel = rng.integers(0, 8, (B, T, Y, X))
    elif c["cmds"] == "none":
        btype[:] = 0
    elif c["cmds"] == "high":
        btype = rng.integers(1, 4, (B, T, nb))
        sel = rng.integers(8, 256, (B, T, Y, X))
    colors = rng.integers(0, 1 << 32, (B, T, nb, 8), dtype=np.uint32)
    changes = rng.random((B, T)) < 0.7
    init_valid = rng.random(B) < 0.5
    init_valid[0] = False
    return (init, btype.astype(np.uint8), sel.astype(np.uint8), colors,
            changes, init_valid, c["insign"])


def msv1_case(name):
    """The case as contiguous CPU tensors → (init, btype, sel, colors,
    changes, init_valid, insign_lines)."""
    init, btype, sel, colors, chg, valid, insign = case_inputs(name)
    return (t32(init), torch.from_numpy(btype), torch.from_numpy(sel),
            t32(colors), torch.from_numpy(chg), torch.from_numpy(valid),
            insign)


def shifted(t, offset=1):
    """A copy of t in a fresh flat buffer, starting `offset` elements in."""
    buf = torch.zeros(t.numel() + offset, dtype=t.dtype, device=t.device)
    v = buf[offset:].view(t.shape)
    v.copy_(t)
    return v


def in_window(t, fill=0):
    """t [B, T, ...] as steps [1, 1+T) of a fresh [B, T+2, ...] stack →
    (the view, the stack)."""
    B, T = t.shape[:2]
    stack = torch.full((B, T + 2) + tuple(t.shape[2:]), fill, dtype=t.dtype,
                       device=t.device)
    stack[:, 1:1 + T] = t
    return stack[:, 1:1 + T], stack


def run_msv1_case(name, device):
    """msv1_paint on the case, in the case's layout on `device` → (inputs
    as made on the CPU, frames on the CPU, diff on the CPU).  Checks that
    the wrapper wrote only its slots and counted its launch (one on the
    card, none for CPU tensors)."""
    from jsplayer_tpu_torch.kernels.msv1_paint import msv1_paint

    init, btype, sel, colors, chg, valid, insign = msv1_case(name)
    B, T = btype.shape[:2]
    Y, X = init.shape[1:]
    d = [t.to(device) for t in (init, btype, sel, colors)]
    layout = spec(name)["layout"]
    out = torch.full((B, T, Y, X), FILL, dtype=torch.int32, device=device)
    stack = None
    if layout == "offset":
        d = [shifted(t) for t in d]
        out = shifted(out)
    elif layout == "slice":
        d = [d[0]] + [in_window(t)[0] for t in d[1:]]
        out, stack = in_window(out, FILL)
    before = msv1_paint.launches
    frames, diff = msv1_paint(*d, insign, out=out)
    assert frames.data_ptr() == out.data_ptr()
    assert msv1_paint.launches == before + (torch.device(device).type ==
                                            "cuda")
    if stack is not None:
        assert (stack[:, 0] == FILL).all() and (stack[:, -1] == FILL).all()
    return (init, btype, sel, colors, chg, valid, insign), frames.cpu(), \
        diff.cpu()


def vector_path(name):
    """Whether the kernel takes its staged instance (16-byte loads and
    stores, copies of 4-byte sel words and 8-byte colour pairs): every
    layout but offset (MSV1 frames are whole blocks, so X % 4 == 0)."""
    return spec(name)["layout"] != "offset"


# -- the table covers what it claims -----------------------------------------

def test_msv1_cases_cover_shapes_layouts_and_commands():
    specs = {n: spec(n) for n in MSV1_CASES}
    for what, claim in (
            ("x_not_128", lambda c: c["X"] % 128 != 0),
            ("x_past_128", lambda c: c["X"] > 4 * 128),
            ("y_not_8", lambda c: c["Y"] % 8 != 0),
            ("offset", lambda c: c["layout"] == "offset"),
            ("slice", lambda c: c["layout"] == "slice"),
            ("insign", lambda c: c["insign"] > 0),
            ("all", lambda c: c["cmds"] == "all"),
            ("none", lambda c: c["cmds"] == "none"),
            ("high", lambda c: c["cmds"] == "high"),
            ("b1_t1", lambda c: c["B"] == 1 and c["T"] == 1),
            ("b5", lambda c: c["B"] == 5),
            ("under_ring", lambda c: c["T"] == RING - 1),
            ("ring", lambda c: c["T"] == RING),
            ("over_ring", lambda c: c["T"] == RING + 1),
            ("flush", lambda c: c["T"] == FLUSH),
            ("past_flush", lambda c: c["T"] == FLUSH + 1),
            ("two_flushes", lambda c: c["T"] > 2 * FLUSH),
            ("cif", lambda c: c["X"] == 352),
            ("x320", lambda c: c["X"] == 320),
            ("warp_part", lambda c: (c["X"] // 4) % 8 != 0),
            ("long_all", lambda c: c["cmds"] == "all" and c["T"] > FLUSH),
            ("long_slice", lambda c: c["layout"] == "slice"
             and c["T"] > FLUSH),
            ("insign_last", lambda c: c["insign"] == c["Y"] - 1)):
        assert any(claim(c) for c in specs.values()), what
    assert not all(vector_path(n) for n in MSV1_CASES)


def test_ring_and_flush_match_the_kernel():
    """RING and FLUSH are csrc/msv1_paint.cu's kRing and kChunk."""
    src = open(os.path.join(os.path.dirname(__file__), os.pardir,
                            "jsplayer_tpu_torch", "csrc",
                            "msv1_paint.cu")).read()
    got = {k: int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
           for k in ("kRing", "kChunk")}
    assert got == {"kRing": RING, "kChunk": FLUSH}


def test_msv1_cases_hold_every_btype_and_index():
    """btype 0 and each value > 0, sel below 8 and at or above 8 in painted
    blocks, changes and init_valid both ways."""
    seen = dict(bt0=0, bt1=0, bt2=0, bt3=0, sel_lo=0, sel_hi=0, chg=0,
                still=0, valid=0, invalid=0)
    for name in MSV1_CASES:
        init, btype, sel, colors, chg, valid, _ = case_inputs(name)
        for v in range(4):
            seen[f"bt{v}"] += int((btype == v).sum())
        Y, X = init.shape[1:]
        painted = np.repeat(np.repeat(
            btype.reshape(btype.shape[:2] + (Y // 4, X // 4)) > 0, 4, 2),
            4, 3)
        seen["sel_lo"] += int((painted & (sel < 8)).sum())
        seen["sel_hi"] += int((painted & (sel >= 8)).sum())
        seen["chg"] += int(chg.sum())
        seen["still"] += int((~chg).sum())
        seen["valid"] += int(valid.sum())
        seen["invalid"] += int((~valid).sum())
    assert all(v > 0 for v in seen.values()), seen


@pytest.mark.parametrize("name", sorted(MSV1_CASES))
def test_msv1_case_runs_on_the_cpu_as_its_plain_twin(name):
    """On CPU tensors msv1_paint is its plain twin, written into the case's
    strided out and counting no launch."""
    from jsplayer_tpu_torch.kernels.msv1_paint import msv1_paint_ref

    args, frames, diff = run_msv1_case(name, "cpu")
    want_f, want_d = msv1_paint_ref(*args[:4], args[6])
    assert torch.equal(frames, want_f) and torch.equal(diff, want_d)

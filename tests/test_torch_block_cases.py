"""BLOCK_CASES: one table of csrc/sp_motion.cu steps, each a shape, a
layout of the planes and a kind of commands that picks a path of the
kernel.  Both sides draw from it: tests/test_torch_cuda.py
(test_block_kernel_cases, each mode's kernel against its plain twin on the
card) and tests/test_torch_sp_motion.py (each plain twin against the JAX
package on the CPU).  The tests here hold the table to what it claims to
cover.  numpy and torch only: the card side runs where jax is absent."""

import zlib

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

MODES = ("general", "fused", "mxu")
FILL = 0x7EADBEEF  # what a slot next to `out` holds, and must keep

#: name → B, Y, X; changed (default all), layout (default "contig"),
#: motion (default "inside"), rects (default "random").
#:   layout  "offset": each plane's base one word in (the 4-byte path);
#:           "odd_stride": planes Y*X + 1 words apart (the 4-byte path);
#:           "window": prev and out are frames[:, 0] and frames[:, 1] of a
#:           [B, 3, Y, X] stack, the pixel plane payload[:, 1] of a window
#:   motion  "inside": every source window in the frame, mx % 4 of any
#:           value; "mx4" / "mx_odd": most blocks bts 3 with mx % 4 == 0 /
#:           != 0; "edges": edge blocks move from 1-40 pixels outside
#:           their edge, some vectors wrap int32
#:   rects   "random": edges anywhere near the block; "split": data blocks
#:           whose rect edges cut 4-pixel vectors
#: bts runs over -1..7 everywhere; unchanged streams carry garbage commands.
BLOCK_CASES = {
    "x_not_4": dict(B=3, Y=48, X=70, changed=[1, 0, 1]),
    "odd_y_x": dict(B=2, Y=33, X=71),
    "y_not_16": dict(B=2, Y=40, X=128),
    "offset_base": dict(B=3, Y=32, X=128, layout="offset",
                        changed=[1, 1, 0]),
    "odd_stride": dict(B=2, Y=48, X=128, layout="odd_stride"),
    "window_view": dict(B=2, Y=32, X=256, layout="window"),
    "split_rects": dict(B=2, Y=32, X=128, rects="split"),
    "motion_mx4": dict(B=2, Y=48, X=128, motion="mx4"),
    "motion_mx_odd": dict(B=2, Y=48, X=128, motion="mx_odd"),
    "out_of_frame": dict(B=2, Y=48, X=64, motion="edges"),
    "odd_out_of_frame": dict(B=2, Y=37, X=45, motion="edges",
                             layout="offset"),
    "unchanged_garbage": dict(B=3, Y=32, X=128, changed=[0, 1, 0]),
    "b1": dict(B=1, Y=32, X=128),
    "b5": dict(B=5, Y=32, X=128, changed=[1, 0, 1, 1, 0]),
}


def spec(name):
    c = dict(changed=None, layout="contig", motion="inside", rects="random")
    c.update(BLOCK_CASES[name])
    if c["changed"] is None:
        c["changed"] = [1] * c["B"]
    return c


def case_commands(name):
    """numpy commands of the case → (prev u32 [B, Y, X], bts [B, NB], mv
    [B, NB, 2], rect [B, NB, 4] int32, payload u32 [B, Y, X], changed
    [B] bool), made from a seed the name gives."""
    c = spec(name)
    B, Y, X = c["B"], c["Y"], c["X"]
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    nby, nbx = (Y + 15) // 16, (X + 15) // 16
    nb = nby * nbx
    by, bx = (np.arange(nb) // nbx) * 16, (np.arange(nb) % nbx) * 16
    bts = rng.integers(-1, 8, (B, nb))
    # source windows inside the frame
    sy = rng.integers(0, max(Y - 15, 1), (B, nb))
    sx = rng.integers(0, max(X - 15, 1), (B, nb))
    if c["motion"] in ("mx4", "mx_odd"):
        bts = np.where(rng.random((B, nb)) < 0.75, 3, bts)
        sx = sx & ~3
        if c["motion"] == "mx_odd":
            sx = np.minimum(sx + rng.integers(1, 4, (B, nb)), X - 16)
    mv = np.stack([sx - bx, sy - by], -1)
    if c["motion"] == "edges":
        step = rng.integers(1, 41, (B, nb))
        for edge, axis, sign in ((by == 0, 1, -1),
                                 (by == (nby - 1) * 16, 1, 1),
                                 (bx == 0, 0, -1),
                                 (bx == (nbx - 1) * 16, 0, 1)):
            mv[..., axis] = np.where(edge, sign * step, mv[..., axis])
        bts = np.where(rng.random((B, nb)) < 0.5, 3, bts)
        mv[:, 1] = (2**31 - 9, -(2**31) + 5)  # the general mode wraps
    x0 = bx + rng.integers(-2, 10, (B, nb))
    y0 = by + rng.integers(-2, 10, (B, nb))
    w = rng.integers(0, 12, (B, nb))
    if c["rects"] == "split":
        x0 = bx + rng.choice([1, 2, 3, 5, 6, 7, 9, 10], (B, nb))
        w = rng.choice([1, 2, 3, 5, 6], (B, nb))
        bts = rng.choice([1, 2, 4, 5, 6, 3, 7], (B, nb))
    rect = np.stack([x0, y0, x0 + w, y0 + rng.integers(0, 12, (B, nb))], -1)
    chg = np.array(c["changed"], dtype=bool)
    for b in np.nonzero(~chg)[0]:  # garbage an unchanged stream never reads
        bts[b] = rng.integers(-(2**31), 2**31, nb)
        mv[b] = rng.integers(-(2**31), 2**31, (nb, 2))
        rect[b] = rng.integers(-(2**31), 2**31, (nb, 4))
    prev, payload = (rng.integers(0, 1 << 32, (B, Y, X), dtype=np.uint32)
                     for _ in range(2))
    return (prev, bts.astype(np.int32), mv.astype(np.int32),
            rect.astype(np.int32), payload, chg)


def t32(a):
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def block_case(name, mode):
    """The case's step for `mode` → (prev, args, changed): contiguous CPU
    tensors, args the wrapper's arguments between prev and changed.  The
    mxu mode takes mxu_commands of the same commands, with prev's pixels
    24-bit (the JAX kernel's matmul is exact there), random top bytes on a
    third of the paycode words and is_motion of 0, 1 and 2 (bts 4 blocks
    move too); an unchanged stream's src_yx and is_motion are garbage."""
    from jsplayer_tpu_torch.kernels.sp_motion_mxu import mxu_commands

    prev, bts, mv, rect, payload, chg = case_commands(name)
    cmds = [t32(a) for a in (bts, mv, rect, payload)]
    if mode != "mxu":
        return t32(prev), cmds, torch.from_numpy(chg)
    rng = np.random.default_rng(zlib.crc32(name.encode()) + 1)
    pc, src, im = (torch.stack(c) for c in zip(*(
        mxu_commands(*(c[b] for c in cmds)) for b in range(len(chg)))))
    top = rng.integers(0, 256, pc.shape) * (rng.random(pc.shape) < 1 / 3)
    pc = pc ^ t32((top << 24).astype(np.uint32))
    im = (im + t32(bts == 4).to(torch.int32)) * t32(
        rng.integers(1, 3, im.shape).astype(np.int32))
    for b in np.nonzero(~chg)[0]:
        src[b] = t32(rng.integers(-(2**31), 2**31, src[b].shape)
                     .astype(np.int32))
        im[b] = t32(rng.integers(-5, 5, im[b].shape).astype(np.int32))
    return t32(prev & 0x00FFFFFF), [pc, src, im], torch.from_numpy(chg)


def case_fns(mode):
    """(wrapper, plain one-frame twin) of a mode."""
    from jsplayer_tpu_torch.kernels import sp_motion_mxu as PM
    from jsplayer_tpu_torch.kernels import sp_motion_pallas as PP
    from jsplayer_tpu_torch.kernels import sp_recon as P

    return {"general": (P.sp_compose_general, P.compose_frame_ref),
            "fused": (PP.sp_motion_patch, PP.compose_frame_fast_ref),
            "mxu": (PM.sp_motion_mxu, PM.compose_frame_mxu_ref)}[mode]


def rows_view(t, offset, pad):
    """A copy of t [B, Y, X] in a fresh buffer, as a view whose rows stay
    contiguous but whose start lies `offset` words in and whose planes lie
    Y*X + pad words apart (offset 1 or an odd pad: not 16-byte aligned)."""
    B, Y, X = t.shape
    buf = torch.full((offset + B * (Y * X + pad),), 0x5A5A5A5A,
                     dtype=torch.int32, device=t.device)
    v = torch.as_strided(buf, (B, Y, X), (Y * X + pad, X, 1), offset)
    v.copy_(t)
    return v


def case_planes(name, prev, pix):
    """prev and the pixel plane (payload or paycode) in the case's layout,
    on their device, and an `out` of the same layout filled with FILL →
    (prev, pix, out, stack): stack is the window layout's [B, 3, Y, X]
    frames (prev at slot 0, out at 1, slot 2 untouched), else None."""
    layout = spec(name)["layout"]
    fill = torch.full_like(prev, FILL)
    if layout == "window":
        B, Y, X = prev.shape
        stack = torch.full((B, 3, Y, X), FILL, dtype=torch.int32,
                           device=prev.device)
        stack[:, 0] = prev
        win = torch.zeros((B, 2, Y, X), dtype=torch.int32,
                          device=prev.device)
        win[:, 1] = pix
        return stack[:, 0], win[:, 1], stack[:, 1], stack
    if layout == "contig":
        return prev.clone(), pix.clone(), fill, None
    offset, pad = {"offset": (1, 0), "odd_stride": (0, 1)}[layout]
    return (rows_view(prev, offset, pad), rows_view(pix, offset, pad),
            rows_view(fill, offset, pad), None)


def run_case(name, mode, device):
    """Run the mode's wrapper on the case, its planes in the case's layout
    on `device` → (prev, args, changed as made on the CPU, out on the CPU).
    Checks that the wrapper wrote only its slot and counted its launches
    (one on the card, none for CPU tensors)."""
    prev, args, chg = block_case(name, mode)
    step, _ = case_fns(mode)
    pix = args[0] if mode == "mxu" else args[3]
    pv, px, out, stack = case_planes(name, prev.to(device), pix.to(device))
    dev_args = [a.to(device) for a in args]
    dev_args[0 if mode == "mxu" else 3] = px
    before = step.launches
    got = step(pv, *dev_args, chg.to(device), out=out)
    assert got.data_ptr() == out.data_ptr()
    assert step.launches == before + (torch.device(device).type == "cuda")
    if stack is not None:
        assert torch.equal(stack[:, 0].cpu(), prev)
        assert (stack[:, 2] == FILL).all()
    return prev, args, chg, out.cpu()


def vector_path(prev, pix, out):
    """Whether csrc/sp_motion.cu's launch picks its 16-byte instance for
    these planes: X % 4 == 0, 16-byte aligned bases, batch strides a
    multiple of 4 words."""
    return all(t.shape[-1] % 4 == 0 and t.data_ptr() % 16 == 0
               and t.stride(0) % 4 == 0 for t in (prev, pix, out))


# -- the table covers what it claims -----------------------------------------

@pytest.mark.parametrize("name", sorted(BLOCK_CASES))
def test_block_case_picks_its_kernel_path(name):
    """The 16-byte instance runs where X % 4 == 0 in the contiguous and
    window layouts; the offset and odd-stride layouts and X % 4 != 0 take
    the 4-byte instance."""
    c = spec(name)
    prev, args, _ = block_case(name, "general")
    planes = case_planes(name, prev, args[3])[:3]
    want = c["X"] % 4 == 0 and c["layout"] in ("contig", "window")
    assert vector_path(*planes) == want


def motion_sources(name):
    """(bts, source windows' (sy, sx) [B, NB, 2], changed) of the case."""
    _, bts, mv, _, _, chg = case_commands(name)
    c = spec(name)
    nbx = (c["X"] + 15) // 16
    blk = np.arange(bts.shape[1])
    origin = np.stack([(blk // nbx) * 16, (blk % nbx) * 16], -1)
    return bts, origin + mv[..., ::-1].astype(np.int64), chg


def changed_blocks(name):
    _, bts, mv, rect, _, chg = case_commands(name)
    return bts[chg], mv[chg], rect[chg]


def test_block_cases_cover_shapes_and_layouts():
    """X % 4 != 0, odd Y and X, Y % 16 != 0, an offset base, an odd batch
    stride, a window view, B = 1 and 5, and unchanged streams."""
    specs = [spec(n) for n in BLOCK_CASES]
    for what, claim in (
            ("x_not_4", lambda c: c["X"] % 4 != 0),
            ("odd_y_and_x", lambda c: c["Y"] % 2 == 1 and c["X"] % 2 == 1),
            ("y_not_16", lambda c: c["Y"] % 16 != 0),
            ("offset_base", lambda c: c["layout"] == "offset"),
            ("odd_batch_stride", lambda c: c["layout"] == "odd_stride"),
            ("window_view", lambda c: c["layout"] == "window"),
            ("b1", lambda c: c["B"] == 1),
            ("b5", lambda c: c["B"] == 5),
            ("unchanged", lambda c: not all(c["changed"]))):
        assert any(claim(c) for c in specs), what


def test_block_cases_hold_every_bts_and_split_vectors():
    """bts -1..7 in changed streams; data rects whose column edges cut a
    4-pixel vector (x % 4 != 0) inside their block."""
    seen, split = set(), 0
    for name in BLOCK_CASES:
        bts, _, rect = changed_blocks(name)
        seen |= set(np.unique(bts).tolist())
        data = (bts > 0) & (bts != 3) & (rect[..., 2] > rect[..., 0])
        split += int((data & ((rect[..., 0] % 4 != 0)
                              | (rect[..., 2] % 4 != 0))).sum())
    assert set(range(-1, 8)) <= seen
    assert split > 100


def test_block_cases_move_aligned_unaligned_and_out_of_frame():
    """bts-3 sources with mx % 4 == 0 and != 0 inside the frame, and
    sources that leave it across each of the four edges."""
    aligned = unaligned = 0
    edges = set()
    for name in BLOCK_CASES:
        c = spec(name)
        bts, src, chg = motion_sources(name)
        bts, src = bts[chg], src[chg]
        mx = src[..., 1] % 16  # bx is a multiple of 16
        inside = ((src[..., 0] >= 0) & (src[..., 0] <= c["Y"] - 16)
                  & (src[..., 1] >= 0) & (src[..., 1] <= c["X"] - 16))
        motion = bts == 3
        aligned += int((motion & inside & (mx % 4 == 0)).sum())
        unaligned += int((motion & inside & (mx % 4 != 0)).sum())
        m = motion & ~inside
        for edge, hit in (("top", src[..., 0] < 0),
                          ("bottom", src[..., 0] + 16 > c["Y"]),
                          ("left", src[..., 1] < 0),
                          ("right", src[..., 1] + 16 > c["X"])):
            if (m & hit).any():
                edges.add(edge)
    assert aligned > 50 and unaligned > 50
    assert edges == {"top", "bottom", "left", "right"}


def test_unchanged_streams_carry_garbage():
    """Every unchanged stream's commands are far outside any frame: a
    kernel that read them would write garbage or fault."""
    n = 0
    for name in BLOCK_CASES:
        _, bts, mv, rect, _, chg = case_commands(name)
        for b in np.nonzero(~chg)[0]:
            assert np.abs(mv[b].astype(np.int64)).max() > 2**20
            assert (bts[b] > 7).any() and (bts[b] < -1).any()
            n += 1
    assert n >= 5


@pytest.mark.parametrize("mode", MODES)
def test_block_case_runs_on_the_cpu_as_its_plain_twin(mode):
    """On CPU tensors each wrapper is its plain twin, written into the
    case's strided out and counting no launch, for every case."""
    from jsplayer_tpu_torch.kernels.sp_recon import per_stream_ref

    for name in BLOCK_CASES:
        prev, args, chg, got = run_case(name, mode, "cpu")
        want = per_stream_ref(case_fns(mode)[1], prev, chg, *args)
        assert torch.equal(got, want), name

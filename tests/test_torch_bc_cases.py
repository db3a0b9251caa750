"""BC_CASES: one table of csrc/bc_compose.cu steps, each a shape, a layout
of the planes and command arrays, and a kind of commands that picks a path
of the kernel.  Both sides draw from it: tests/test_torch_cuda.py
(test_bc_kernel_cases, the kernel against its plain twin on the card) and
tests/test_torch_bc.py (the plain twin against the JAX package on the
CPU).  The tests here hold the table to what it claims to cover.  numpy and
torch only: the card side runs where jax is absent."""

import zlib

import numpy as np
import pytest
import torch

from test_torch_block_cases import FILL, rows_view, t32

torch.set_num_threads(1)

INT_MIN = -(2**31)

#: name → B, Y, X; K (default 2), changed (default all), layout (default
#: "contig"), motion (default "inside"), rects (default "random").
#:   layout  "offset": each plane's base one word in (the 4-byte path);
#:           "odd_stride": planes Y*X + 1 words apart (the 4-byte path);
#:           "window": prev and out are frames[:, 0] and frames[:, 1] of a
#:           [B, 3, Y, X] stack, plane, bcode, rloc and mvk slot 1 of
#:           [B, 2, ...] windows;
#:           "rloc_bytes": rloc rows start one byte in (its byte loads)
#:   motion  "inside": vectors of up to 20 pixels; "mx4": mx % 4 == 0 (the
#:           16-byte moved loads); "wrap": |mv| >= Y or X, negative, near
#:           +-2^31 and -2^31 itself
#:   rects   "random": bounds 0..20 (past 16, x0 >= x1 and y0 >= y1 too), a
#:           third whole blocks; "split": data rects whose column edges cut
#:           4-pixel vectors; "full": whole blocks
#: Codes run over 0..K+3 (codes >= 2+K copy) and 255; unchanged streams
#: carry garbage commands, and every plane word is random, data rect or not.
BC_CASES = {
    "x_not_4": dict(B=3, Y=48, X=70, changed=[1, 0, 1]),
    "odd_y_x": dict(B=2, Y=33, X=71),
    "y_not_16": dict(B=2, Y=40, X=128),
    "offset_base": dict(B=3, Y=32, X=128, layout="offset",
                        changed=[1, 1, 0]),
    "odd_stride": dict(B=2, Y=48, X=128, layout="odd_stride"),
    "window_view": dict(B=2, Y=32, X=256, layout="window"),
    "rloc_bytes": dict(B=2, Y=32, X=128, layout="rloc_bytes"),
    "full_rects_mx4": dict(B=2, Y=48, X=128, rects="full", motion="mx4"),
    "split_rects": dict(B=2, Y=32, X=128, rects="split"),
    "wrapping": dict(B=4, Y=56, X=80, motion="wrap", changed=[1, 1, 0, 1]),
    "odd_wrapping": dict(B=2, Y=37, X=45, motion="wrap", layout="offset"),
    "k0": dict(B=2, Y=48, X=80, K=0),
    "k8": dict(B=3, Y=48, X=80, K=8, changed=[1, 0, 1]),
    "unchanged_garbage": dict(B=3, Y=32, X=128, changed=[0, 1, 0]),
    "b1": dict(B=1, Y=32, X=128),
    "b5": dict(B=5, Y=32, X=128, changed=[1, 0, 1, 1, 0]),
}


def spec(name):
    c = dict(K=2, changed=None, layout="contig", motion="inside",
             rects="random")
    c.update(BC_CASES[name])
    if c["changed"] is None:
        c["changed"] = [1] * c["B"]
    return c


def case_commands(name):
    """numpy inputs of the case → (prev u32 [B, Y, X], plane u32 [B, Y, X],
    bcode u8 [B, NB], rloc u8 [B, NB, 4], mvk int32 [B, K, 2], changed [B]
    bool), made from a seed the name gives."""
    return commands_of(spec(name), np.random.default_rng(
        zlib.crc32(name.encode())))


def commands_of(c, rng):
    """case_commands of a spec dict c (BC_CASES' keys, all given), drawn
    from rng (which the lane cases go on drawing from)."""
    B, Y, X, K = c["B"], c["Y"], c["X"], c["K"]
    nb = ((Y + 15) // 16) * ((X + 15) // 16)
    bcode = rng.integers(0, K + 4, (B, nb))
    bcode = np.where(rng.random((B, nb)) < 0.05, 255, bcode)
    lo, hi = rng.integers(0, 19, (B, nb, 2)), rng.integers(0, 21, (B, nb, 2))
    rloc = np.stack([lo[..., 0], lo[..., 1], hi[..., 0], hi[..., 1]], -1)
    whole = rng.random((B, nb)) < 1 / 3
    if c["rects"] == "split":
        x0 = rng.choice([1, 2, 3, 5, 6, 7, 9, 10], (B, nb))
        rloc[..., 0], rloc[..., 2] = x0, x0 + rng.choice([1, 2, 3, 5, 6],
                                                         (B, nb))
        bcode = rng.choice([1, 1, 1, 0, 2, 3], (B, nb))
    elif c["rects"] == "full":
        whole[:] = True
        bcode = rng.integers(0, K + 2, (B, nb))
    rloc[whole] = (0, 0, 16, 16)
    if c["motion"] == "wrap":
        mvk = np.stack([rng.integers(X, 3 * X, (B, K)),
                        rng.integers(Y, 3 * Y, (B, K))], -1)
        mvk *= rng.choice([-1, 1], mvk.shape)
        extremes = np.array([2**31 - 9, -(2**31) + 5, INT_MIN, -1])
        mvk = np.where(rng.random(mvk.shape) < 0.4,
                       rng.choice(extremes, mvk.shape), mvk)
    else:
        mvk = rng.integers(-20, 21, (B, K, 2))
        if c["motion"] == "mx4":
            mvk[..., 0] &= ~3
    chg = np.array(c["changed"], dtype=bool)
    for b in np.nonzero(~chg)[0]:  # garbage an unchanged stream never reads
        bcode[b] = rng.integers(0, 256, nb)
        rloc[b] = rng.integers(0, 256, (nb, 4))
        mvk[b] = rng.integers(-(2**31), 2**31, (K, 2))
    prev, plane = (rng.integers(0, 1 << 32, (B, Y, X), dtype=np.uint32)
                   for _ in range(2))
    return (prev, plane, bcode.astype(np.uint8), rloc.astype(np.uint8),
            mvk.astype(np.int32), chg)


def bc_case(name):
    """The case's step as contiguous CPU tensors → (prev, [plane, bcode,
    rloc, mvk], changed)."""
    prev, plane, bcode, rloc, mvk, chg = case_commands(name)
    return (t32(prev), [t32(plane), torch.from_numpy(bcode),
                        torch.from_numpy(rloc), torch.from_numpy(mvk)],
            torch.from_numpy(chg))


def slot_view(t, slot=1, slots=2):
    """t [B, ...] copied into slot `slot` of a fresh [B, slots, ...] stack
    → that slot's strided view."""
    stack = torch.zeros((t.shape[0], slots) + tuple(t.shape[1:]),
                        dtype=t.dtype, device=t.device)
    stack[:, slot] = t
    return stack[:, slot]


def bytes_view(t, offset=1):
    """A copy of a uint8 t [B, NB, 4] whose rows start `offset` bytes into
    a fresh buffer and whose planes lie NB*4 + offset bytes apart."""
    B, nb, w = t.shape
    buf = torch.full((offset + B * (nb * w + offset),), 0xA5,
                     dtype=torch.uint8, device=t.device)
    v = torch.as_strided(buf, t.shape, (nb * w + offset, w, 1), offset)
    v.copy_(t)
    return v


def case_layout(name, prev, args):
    """prev and args in the case's layout on their device, and an `out` of
    that layout filled with FILL → (prev, args, out, stack): stack is the
    window layout's [B, 3, Y, X] frames (prev at slot 0, out at 1, slot 2
    untouched), else None."""
    layout = spec(name)["layout"]
    plane, bcode, rloc, mvk = args
    fill = torch.full_like(prev, FILL)
    if layout == "window":
        B, Y, X = prev.shape
        stack = torch.full((B, 3, Y, X), FILL, dtype=torch.int32,
                           device=prev.device)
        stack[:, 0] = prev
        return (stack[:, 0], [slot_view(a) for a in args], stack[:, 1],
                stack)
    if layout == "rloc_bytes":
        return (prev.clone(), [plane.clone(), bcode.clone(),
                               bytes_view(rloc), mvk.clone()], fill, None)
    if layout == "contig":
        return prev.clone(), [a.clone() for a in args], fill, None
    offset, pad = {"offset": (1, 0), "odd_stride": (0, 1)}[layout]
    return (rows_view(prev, offset, pad),
            [rows_view(plane, offset, pad), bcode, rloc, mvk],
            rows_view(fill, offset, pad), None)


def run_bc_case(name, device):
    """bc_compose on the case, in the case's layout on `device` → (prev,
    args, changed as made on the CPU, out on the CPU).  Checks that the
    wrapper wrote only its slot and counted its launch (one on the card,
    none for CPU tensors)."""
    from jsplayer_tpu_torch.kernels.sp_recon import bc_compose

    prev, args, chg = bc_case(name)
    pv, dev_args, out, stack = case_layout(
        name, prev.to(device), [a.to(device) for a in args])
    before = bc_compose.launches
    got = bc_compose(pv, *dev_args, chg.to(device), out=out)
    assert got.data_ptr() == out.data_ptr()
    assert bc_compose.launches == before + (torch.device(device).type ==
                                            "cuda")
    if stack is not None:
        assert torch.equal(stack[:, 0].cpu(), prev)
        assert (stack[:, 2] == FILL).all()
    return prev, args, chg, out.cpu()


def vector_path(prev, plane, out):
    """Whether csrc/bc_compose.cu picks its 16-byte instance for these
    planes: X % 4 == 0, 16-byte aligned bases, batch strides a multiple of
    4 words."""
    return all(t.shape[-1] % 4 == 0 and t.data_ptr() % 16 == 0
               and t.stride(0) % 4 == 0 for t in (prev, plane, out))


# -- the table covers what it claims -----------------------------------------

@pytest.mark.parametrize("name", sorted(BC_CASES))
def test_bc_case_picks_its_kernel_path(name):
    """The 16-byte instance runs where X % 4 == 0 in the contiguous, window
    and rloc_bytes layouts; the offset and odd-stride layouts and X % 4 !=
    0 take the 4-byte instance.  rloc is read as one word a block unless
    its rows start off a 4-byte boundary."""
    c = spec(name)
    prev, args, _ = bc_case(name)
    pv, (plane, _, rloc, _), out, _ = case_layout(name, prev, args)
    want = c["X"] % 4 == 0 and c["layout"] in ("contig", "window",
                                               "rloc_bytes")
    assert vector_path(pv, plane, out) == want
    word = rloc.data_ptr() % 4 == 0 and rloc.stride(0) % 4 == 0
    assert word == (c["layout"] != "rloc_bytes")


def changed_commands(name):
    _, _, bcode, rloc, mvk, chg = case_commands(name)
    return spec(name), bcode[chg], rloc[chg], mvk[chg]


def test_bc_cases_cover_shapes_and_layouts():
    """X % 4 != 0, odd Y and X, Y % 16 != 0, an offset base, an odd batch
    stride, window views, byte-aligned rloc rows, B = 1 and 5, K = 0 and 8,
    and unchanged streams."""
    specs = [spec(n) for n in BC_CASES]
    for what, claim in (
            ("x_not_4", lambda c: c["X"] % 4 != 0),
            ("odd_y_and_x", lambda c: c["Y"] % 2 == 1 and c["X"] % 2 == 1),
            ("y_not_16", lambda c: c["Y"] % 16 != 0),
            ("offset_base", lambda c: c["layout"] == "offset"),
            ("odd_batch_stride", lambda c: c["layout"] == "odd_stride"),
            ("window_view", lambda c: c["layout"] == "window"),
            ("rloc_bytes", lambda c: c["layout"] == "rloc_bytes"),
            ("b1", lambda c: c["B"] == 1),
            ("b5", lambda c: c["B"] == 5),
            ("k0", lambda c: c["K"] == 0),
            ("k8", lambda c: c["K"] == 8),
            ("unchanged", lambda c: not all(c["changed"]))):
        assert any(claim(c) for c in specs), what


def test_bc_cases_hold_every_code_rect_and_vector():
    """In changed streams: codes 0, 1, every motion slot, codes >= 2+K and
    255; rects past 16, with x0 >= x1 and with y0 >= y1, and data rects
    whose column edges cut 4-pixel vectors; vectors that are negative, >= Y
    or X, near +-2^31, -2^31 itself, and mx % 4 == 0 besides 0."""
    seen = dict(copy=0, data=0, motion=0, past_k=0, code255=0, past16=0,
                x_empty=0, y_empty=0, split=0, neg=0, big=0, near31=0,
                int_min=0, mx4=0)
    for name in BC_CASES:
        c, bcode, rloc, mvk = changed_commands(name)
        K = c["K"]
        seen["copy"] += int((bcode == 0).sum())
        seen["data"] += int((bcode == 1).sum())
        seen["motion"] += int(((bcode >= 2) & (bcode < 2 + K)).sum())
        seen["past_k"] += int(((bcode >= 2 + K) & (bcode < 255)).sum())
        seen["code255"] += int((bcode == 255).sum())
        seen["past16"] += int((rloc > 16).sum())
        seen["x_empty"] += int((rloc[..., 0] >= rloc[..., 2]).sum())
        seen["y_empty"] += int((rloc[..., 1] >= rloc[..., 3]).sum())
        data = (bcode == 1) & (rloc[..., 2] > rloc[..., 0])
        seen["split"] += int((data & ((rloc[..., 0] % 4 != 0)
                                      | (rloc[..., 2] % 4 != 0))).sum())
        m = mvk.astype(np.int64)
        seen["neg"] += int((m < 0).sum())
        seen["big"] += int(((np.abs(m[..., 0]) >= c["X"])
                            | (np.abs(m[..., 1]) >= c["Y"])).sum())
        seen["near31"] += int((np.abs(m) > 2**31 - 10).sum())
        seen["int_min"] += int((m == INT_MIN).sum())
        seen["mx4"] += int(((m[..., 0] % 4 == 0) & (m[..., 0] != 0)).sum())
    assert all(v > 0 for v in seen.values()), seen
    assert seen["split"] > 20


def test_unchanged_streams_carry_garbage():
    """Every unchanged stream's commands are garbage: codes up to 255,
    rects far past 16 and vectors far outside any frame."""
    n = 0
    for name in BC_CASES:
        _, _, bcode, rloc, mvk, chg = case_commands(name)
        for b in np.nonzero(~chg)[0]:
            assert bcode[b].max() > 2 + spec(name)["K"] and \
                rloc[b].max() > 200
            assert mvk[b].size == 0 or \
                np.abs(mvk[b].astype(np.int64)).max() > 2**20
            n += 1
    assert n >= 5


@pytest.mark.parametrize("name", sorted(BC_CASES))
def test_bc_case_runs_on_the_cpu_as_its_plain_twin(name):
    """On CPU tensors bc_compose is its plain twin, written into the case's
    strided out and counting no launch."""
    from jsplayer_tpu_torch.kernels.sp_recon import bc_compose_ref

    prev, args, chg, got = run_bc_case(name, "cpu")
    assert torch.equal(got, bc_compose_ref(prev, *args, chg))

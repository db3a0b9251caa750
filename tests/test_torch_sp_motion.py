"""The port's block-command composes (csrc/sp_motion.cu's three modes and
their plain twins) against the JAX package, bit for bit, on the CPU:

  * general — jsplayer_tpu_torch.kernels.sp_recon.compose_frame /
    decode_sequence / decode_batch vs sp_recon's, on random commands
    (bts -1..7, vectors that need clipping) at a size whose block grid is
    ragged;
  * fused   — sp_motion_pallas.decode_sequence_fused / decode_batch_fused vs
    the Pallas kernel in interpret mode, on decoder-produced commands, at a
    width the reference need not pad and at a height and width it pads;
  * mxu     — sp_motion_mxu.compose_frame_mxu_safe vs the Pallas kernel in
    interpret mode, frame by frame (tests/test_sp_motion_kernels.py's
    construction) and on random inputs whose sources reach into the
    reference's zero pad;

  * every case of tests/test_torch_block_cases.py BLOCK_CASES (the table
    the card tests hold each kernel to its twin on) whose commands the
    reference takes: the general mode against compose_frame on all of
    them, fused against decode_sequence_fused(interpret=True) and mxu
    against compose_frame_mxu_safe(interpret=True) where the sources stay
    in the frame and the shape suits the Pallas kernel;

plus what the port pins where the references differ or are undefined: a
source outside the frame reads 0, nothing outside the frame is written,
and an unchanged stream's commands are never read."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jsplayer_tpu.encode.sp_enc import ScreenPressorEncoder, pack_rgb
from jsplayer_tpu.kernels import sp_motion_mxu as JM
from jsplayer_tpu.kernels import sp_motion_pallas as JP
from jsplayer_tpu.kernels import sp_recon as J
from jsplayer_tpu.pipeline.batch import stack_sp_commands
from jsplayer_tpu_torch.kernels import sp_motion_mxu as PM
from jsplayer_tpu_torch.kernels import sp_motion_pallas as PP
from jsplayer_tpu_torch.kernels import sp_recon as P
from test_torch_block_cases import BLOCK_CASES, MODES, run_case, spec

torch.set_num_threads(1)


def t32(a):
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def u32(t):
    return t.numpy().view(np.uint32)


def random_commands(T, Y, X, seed, bts_lo=0, bts_hi=5, mv_range=6):
    """Random SP commands for T frames: bts in [bts_lo, bts_hi), vectors in
    ±mv_range, rects inside or across their block, payload of any 32 bits,
    changed mostly True."""
    rng = np.random.default_rng(seed)
    nby, nbx = (Y + 15) // 16, (X + 15) // 16
    nb = nbx * nby
    bts = rng.integers(bts_lo, bts_hi, (T, nb)).astype(np.int32)
    mv = rng.integers(-mv_range, mv_range + 1, (T, nb, 2)).astype(np.int32)
    bx = (np.arange(nb) % nbx) * 16
    by = (np.arange(nb) // nbx) * 16
    x0 = bx + rng.integers(-2, 10, (T, nb))
    y0 = by + rng.integers(-2, 10, (T, nb))
    rect = np.stack([x0, y0, x0 + rng.integers(0, 12, (T, nb)),
                     y0 + rng.integers(0, 12, (T, nb))], -1).astype(np.int32)
    payload = rng.integers(0, 1 << 32, (T, Y, X), dtype=np.uint64
                           ).astype(np.uint32)
    init = rng.integers(0, 1 << 32, (Y, X), dtype=np.uint64).astype(np.uint32)
    changed = rng.random(T) < 0.8
    return init, bts, mv, rect, payload, changed


def decoded_stream(X, Y, seed, n=6):
    """n frames of a ScreenPressor v4 stream (an I-frame, then vertical and
    horizontal scrolls and a paint) → (per-frame bytes, source frames)."""
    rng = np.random.default_rng(seed)
    enc = ScreenPressorEncoder(4, X, Y)
    f = rng.integers(0, 1 << 24, (Y, X)).astype(np.uint32)
    f[4:9, 4:9] = pack_rgb(1, 2, 3)
    chunks, golds = [enc.encode_i(f.reshape(-1))], [f.copy()]
    for t in range(n - 1):
        f = f.copy()
        if t % 3 == 0:
            f[2:, :] = f[:-2, :].copy()    # scroll down: bts-3 blocks
        elif t % 3 == 1:
            f[:, 3:] = f[:, :-3].copy()    # scroll right
        else:
            f[10:14, 20:40] = pack_rgb(*rng.integers(0, 256, 3))
        chunks.append(enc.encode_p(f.reshape(-1)))
        golds.append(f.copy())
    return chunks, np.stack(golds)


def captured(streams, X, Y):
    """The host stage's captured commands, [B, T, ...] numpy."""
    cmds = stack_sp_commands(streams, X, Y)
    return {k: v[:, 0] for k, v in cmds.items()}


# -- general ----------------------------------------------------------------

@pytest.mark.parametrize("seed,bts_hi,mv_range", [
    (0, 5, 3), (1, 5, 20), (2, 5, 80), (3, 8, 6)])
def test_compose_frame_vs_reference(seed, bts_hi, mv_range):
    """Y=40, X=56: a ragged 3x4 block grid; vectors of up to 80 pixels
    leave the frame and clip."""
    Y, X = 40, 56
    lo = -1 if bts_hi > 5 else 0
    init, bts, mv, rect, payload, _ = random_commands(
        1, Y, X, seed, bts_lo=lo, bts_hi=bts_hi, mv_range=mv_range)
    want = np.asarray(J.compose_frame(
        jnp.asarray(init), jnp.asarray(bts[0]), jnp.asarray(mv[0]),
        jnp.asarray(rect[0]), jnp.asarray(payload[0])))
    args = (t32(init), t32(bts[0]), t32(mv[0]), t32(rect[0]), t32(payload[0]))
    for fn in (P.compose_frame, P.compose_frame_ref):
        np.testing.assert_array_equal(u32(fn(*args)), want)


@pytest.mark.parametrize("insig", [0, 3])
def test_decode_sequence_vs_reference(insig):
    Y, X = 40, 56
    init, bts, mv, rect, payload, changed = random_commands(5, Y, X, seed=7)
    wf, ws = J.decode_sequence(
        jnp.asarray(init), jnp.asarray(bts), jnp.asarray(mv),
        jnp.asarray(rect), jnp.asarray(payload), jnp.asarray(changed),
        jnp.int32(insig))
    gf, gs = P.decode_sequence(t32(init), t32(bts), t32(mv), t32(rect),
                               t32(payload), torch.from_numpy(changed), insig)
    np.testing.assert_array_equal(u32(gf), np.asarray(wf))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))


def test_decode_batch_vs_reference():
    Y, X = 24, 40
    parts = [random_commands(4, Y, X, seed=20 + b, mv_range=30)
             for b in range(3)]
    init, bts, mv, rect, payload, changed = (np.stack(a) for a in zip(*parts))
    changed[1] = False  # a frozen stream
    wf, ws = J.decode_batch(*(jnp.asarray(a) for a in (
        init, bts, mv, rect, payload, changed)), jnp.int32(1))
    gf, gs = P.decode_batch(t32(init), t32(bts), t32(mv), t32(rect),
                            t32(payload), torch.from_numpy(changed), 1)
    np.testing.assert_array_equal(u32(gf), np.asarray(wf))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))


def test_block_broadcast_vs_reference():
    vals = np.arange(3 * 4 * 2, dtype=np.int32).reshape(12, 2)
    want = np.asarray(J.block_broadcast(jnp.asarray(vals), 3, 4, 37, 50))
    got = P.block_broadcast(torch.from_numpy(vals), 3, 4, 37, 50)
    np.testing.assert_array_equal(got.numpy(), want)


# -- fused (Pallas patch kernel) -------------------------------------------

@pytest.mark.parametrize("X,Y", [(128, 32), (144, 40)])
def test_decode_sequence_fused_vs_interpret(X, Y):
    """Decoder-produced commands.  144x40 is padded by the reference to
    256x48, and its bts-3 blocks in the last block row write pad rows that
    the port does not have."""
    chunks, golds = decoded_stream(X, Y, seed=X)
    c = captured([chunks], X, Y)
    nbx = (X + 15) // 16
    last_row = c["bts"][0][:, -nbx:]
    assert (last_row == 3).any()  # motion blocks in the last block row
    args = [c[k][0] for k in ("bts", "mv", "rect", "payload", "changed")]
    init = np.zeros((Y, X), np.uint32)
    wf, ws = JP.decode_sequence_fused(
        jnp.asarray(init), *(jnp.asarray(a) for a in args), jnp.int32(0),
        interpret=True)
    gf, gs = PP.decode_sequence_fused(t32(init), *(t32(a) for a in args), 0)
    np.testing.assert_array_equal(u32(gf), np.asarray(wf))
    np.testing.assert_array_equal(u32(gf), golds)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))


def test_decode_batch_fused_vs_interpret():
    X, Y = 144, 40
    streams, golds = zip(*(decoded_stream(X, Y, seed=s) for s in (3, 4)))
    c = captured(list(streams), X, Y)
    c["changed"][1, 3] = False  # stream 1 holds frame 2 over slot 3
    args = [c[k] for k in ("bts", "mv", "rect", "payload", "changed")]
    init = np.zeros((2, Y, X), np.uint32)
    wf, ws = JP.decode_batch_fused(
        jnp.asarray(init), *(jnp.asarray(a) for a in args), jnp.int32(0),
        interpret=True)
    gf, gs = PP.decode_batch_fused(t32(init), *(t32(a) for a in args), 0)
    np.testing.assert_array_equal(u32(gf), np.asarray(wf))
    np.testing.assert_array_equal(u32(gf[0]), golds[0])
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))


@pytest.mark.parametrize("seed", [0, 1])
def test_compose_frame_fast_random_vs_interpret(seed):
    """Random commands (bts -1..7, any rect, 32-bit payload) whose bts-3
    sources lie in the frame, where the Pallas kernel is defined: bts 4
    takes payload here (the general mode would move it)."""
    Y, X = 48, 256
    init, bts, mv, rect, payload, _ = random_commands(
        1, Y, X, seed=40 + seed, bts_lo=-1, bts_hi=8)
    nbx = X // 16
    blk = np.arange(bts.shape[1])
    rng = np.random.default_rng(seed)
    sy = rng.integers(0, Y - 15, blk.size)
    sx = rng.integers(0, X - 15, blk.size)
    mv[0] = np.stack([sx - (blk % nbx) * 16, sy - (blk // nbx) * 16], -1)
    assert (bts == 4).any() and (bts == 3).any()
    want = np.asarray(JP.compose_frame_fast(
        jnp.asarray(init), jnp.asarray(bts[0]), jnp.asarray(mv[0]),
        jnp.asarray(rect[0]), jnp.asarray(payload[0]), interpret=True))
    args = (t32(init), t32(bts[0]), t32(mv[0]), t32(rect[0]), t32(payload[0]))
    for fn in (PP.compose_frame_fast, PP.compose_frame_fast_ref):
        np.testing.assert_array_equal(u32(fn(*args)), want)


def test_compose_frame_fast_vs_general_on_decoder_commands():
    """On decoder-valid commands the fused and general modes agree."""
    X, Y = 144, 40
    chunks, golds = decoded_stream(X, Y, seed=9)
    c = captured([chunks], X, Y)
    for t in range(1, len(chunks)):
        args = (t32(golds[t - 1]),) + tuple(
            t32(c[k][0, t]) for k in ("bts", "mv", "rect", "payload"))
        fast = PP.compose_frame_fast(*args)
        np.testing.assert_array_equal(u32(fast), golds[t])
        np.testing.assert_array_equal(fast.numpy(),
                                      P.compose_frame(*args).numpy())


# -- mxu (Pallas MXU-shuffle kernel) ---------------------------------------

def numpy_mxu_inputs(bts, mv, rect, payload, X, Y):
    """tests/test_sp_motion_kernels.py's construction of the MXU inputs."""
    nbx = X // 16
    NB = bts.shape[0]
    yy, xx = np.mgrid[0:Y, 0:X]
    bi = (yy >> 4) * nbx + (xx >> 4)
    b = bts[bi]
    r = rect[bi]
    in_rect = ((xx >= r[..., 0]) & (xx < r[..., 2])
               & (yy >= r[..., 1]) & (yy < r[..., 3]))
    is_data = (b > 0) & (b != 3) & in_rect
    paycode = (payload & 0xFFFFFF) | (is_data.astype(np.uint32) << 24)
    by = (np.arange(NB) // nbx) * 16
    bx = (np.arange(NB) % nbx) * 16
    src_yx = np.stack([by + mv[:, 1], bx + mv[:, 0]], axis=-1).astype(np.int32)
    return paycode, src_yx, (bts == 3).astype(np.int32)


@pytest.mark.parametrize("seed", [1, 5])
def test_compose_frame_mxu_safe_frame_by_frame(seed):
    X, Y = 128, 32
    chunks, golds = decoded_stream(X, Y, seed=seed)
    c = captured([chunks], X, Y)
    prev = np.zeros((Y, X), np.uint32)
    for t in range(len(chunks)):
        if not c["changed"][0, t]:
            continue
        cmd = [c[k][0, t] for k in ("bts", "mv", "rect", "payload")]
        paycode, src_yx, is_motion = numpy_mxu_inputs(*cmd, X, Y)
        for got, want in zip(PM.mxu_commands(*(t32(a) for a in cmd)),
                             (paycode, src_yx, is_motion)):
            np.testing.assert_array_equal(got.numpy(), want.view(got.numpy().dtype))
        want = np.asarray(JM.compose_frame_mxu_safe(
            jnp.asarray(prev), jnp.asarray(paycode), jnp.asarray(src_yx),
            jnp.asarray(is_motion), interpret=True))
        got = PM.compose_frame_mxu_safe(t32(prev), t32(paycode), t32(src_yx),
                                        t32(is_motion))
        np.testing.assert_array_equal(u32(got), want)
        np.testing.assert_array_equal(want, golds[t])
        prev = want


def test_compose_frame_mxu_safe_random_into_the_pad():
    """Random paycodes (every top byte) and sources anywhere the
    reference's DMA stays inside its padded frame: rows 0..Y-9 and columns
    0..X-1, so windows reach up to 8 rows and 15 columns past the edge,
    where both read 0."""
    X, Y = 128, 32
    rng = np.random.default_rng(11)
    nb = (X // 16) * (Y // 16)
    prev = rng.integers(0, 1 << 24, (Y, X)).astype(np.uint32)
    paycode = rng.integers(0, 1 << 32, (Y, X), dtype=np.uint64
                           ).astype(np.uint32)
    paycode[::3] &= 0x00FFFFFF  # some copy pixels (top byte 0)
    src_yx = np.stack([rng.integers(0, Y - 8, nb),
                       rng.integers(0, X, nb)], -1).astype(np.int32)
    is_motion = rng.integers(0, 3, nb).astype(np.int32)  # 0, 1 and 2
    want = np.asarray(JM.compose_frame_mxu_safe(
        jnp.asarray(prev), jnp.asarray(paycode), jnp.asarray(src_yx),
        jnp.asarray(is_motion), interpret=True))
    args = (t32(prev), t32(paycode), t32(src_yx), t32(is_motion))
    for fn in (PM.compose_frame_mxu_safe, PM.compose_frame_mxu_ref):
        np.testing.assert_array_equal(u32(fn(*args)), want)


# -- what the port pins ------------------------------------------------------

def test_out_of_frame_sources_read_zero_and_nothing_is_written_outside():
    """Fused and mxu modes: a motion block whose source leaves the frame
    reads 0 there (the references read their pad or are undefined); the
    general mode clips instead.  Each wrapper writes its step into a
    strided slot of a stack and leaves the neighbouring slots alone."""
    Y, X = 40, 56  # last block row and column are partial
    nby, nbx = 3, 4
    nb = nby * nbx
    rng = np.random.default_rng(3)
    prev = rng.integers(1, 1 << 24, (Y, X)).astype(np.uint32)  # no zeros
    payload = np.zeros((Y, X), np.uint32)
    bts = np.zeros(nb, np.int32)
    mv = np.zeros((nb, 2), np.int32)
    rect = np.zeros((nb, 4), np.int32)
    # block (2, 3), partial 8x8: source 5 rows below and 4 columns right
    blk = 2 * nbx + 3
    bts[blk] = 3
    mv[blk] = (4, 5)
    rect[blk] = (48, 32, 56, 40)
    # block (0, 0): source 20 rows above the frame
    bts[0] = 3
    mv[0] = (0, -20)
    rect[0] = (0, 0, 16, 16)
    fill = np.int32(0x7EADBEEF)
    stack = torch.full((1, 3, Y, X), int(fill), dtype=torch.int32)
    chg = torch.ones(1, dtype=torch.bool)
    PP.sp_motion_patch(t32(prev)[None], t32(bts)[None], t32(mv)[None],
                       t32(rect)[None], t32(payload)[None], chg,
                       out=stack[:, 1])
    got = u32(stack[0, 1])
    assert (u32(stack[0, 0]) == np.uint32(fill)).all()
    assert (u32(stack[0, 2]) == np.uint32(fill)).all()
    want = prev.copy()
    want[0:16, 0:16] = 0  # rows -20..-5: all outside
    src = np.zeros((Y + 5, X + 4), np.uint32)
    src[:Y, :X] = prev
    want[32:40, 48:56] = src[37:45, 52:60]
    np.testing.assert_array_equal(got, want)
    assert (got[35:40, 48:56] == 0).all() and (got[32:35, 52:56] == 0).all()
    # the mxu mode, fed the same blocks, reads the same
    paycode, src_yx, is_motion = PM.mxu_commands(
        t32(bts), t32(mv), t32(rect), t32(payload))
    mxu = PM.compose_frame_mxu_safe(t32(prev), paycode, src_yx, is_motion)
    np.testing.assert_array_equal(u32(mxu), want)
    # the general mode clips: the edge row and column repeat
    gen = u32(P.compose_frame(t32(prev), t32(bts), t32(mv), t32(rect),
                              t32(payload)))
    np.testing.assert_array_equal(gen[32:40, 48:56],
                                  prev[np.minimum(np.arange(37, 45), Y - 1)]
                                  [:, np.minimum(np.arange(52, 60), X - 1)])
    np.testing.assert_array_equal(gen[0:16, 0:16], np.repeat(
        prev[0:1, 0:16], 16, axis=0))


@pytest.mark.parametrize("which", ["general", "fused", "mxu"])
def test_unchanged_stream_copies_prev_and_ignores_its_commands(which):
    """A quarantined stream's pooled command rows are stale: with
    changed[b] False the step copies prev[b] whatever the commands say."""
    Y, X = 24, 40
    parts = [random_commands(1, Y, X, seed=30 + b, mv_range=10**6)
             for b in range(2)]
    init, bts, mv, rect, payload, _ = (np.stack(a) for a in zip(*parts))
    chg = torch.tensor([False, True])
    args = [t32(a[:, 0]) for a in (bts, mv, rect, payload)]
    if which == "mxu":
        cmds = [PM.mxu_commands(*(a[b] for a in args)) for b in range(2)]
        args = [torch.stack(c) for c in zip(*cmds)]
        step, ref = PM.sp_motion_mxu, PM.compose_frame_mxu_ref
    elif which == "general":
        step, ref = P.sp_compose_general, P.compose_frame_ref
    else:
        step, ref = PP.sp_motion_patch, PP.compose_frame_fast_ref
    got = step(t32(init), *args, chg)
    np.testing.assert_array_equal(u32(got[0]), init[0])
    np.testing.assert_array_equal(got[1].numpy(),
                                  ref(t32(init[1]), *(a[1] for a in args))
                                  .numpy())


def test_significance_matches_reference_scan():
    bts = np.array([[[0, 0, 2], [0, 1, 0], [0, 0, 0]]], np.int32)
    changed = np.array([[True, True, True]])
    for insig in (0, 1, 2, 3):
        got = P.significance(torch.from_numpy(bts),
                             torch.from_numpy(changed), insig)
        want = [bool(changed[0, t] and (bts[0, t][insig:] > 0).any())
                for t in range(3)]
        assert got[0].tolist() == want


# -- the case table shared with the card tests ----------------------------

def reference_takes(case, mode):
    """Whether the JAX function of `mode` is defined on the case: the
    general compose on every case; the Pallas kernels only where every
    source stays in the frame (outside it the port reads 0 and they read
    their pad, by design), the MXU kernel also only for Y % 16 == 0 and
    X % 128 == 0 (its over-fetch window must fit the padded frame)."""
    c = spec(case)
    if mode == "general":
        return True
    if c["motion"] == "edges":
        return False
    return mode == "fused" or (c["Y"] % 16 == 0 and c["X"] % 128 == 0)


def reference_step(mode, prev, args):
    """One changed stream's step through the JAX package (numpy in and
    out, u32)."""
    pix = 0 if mode == "mxu" else 3  # payload / paycode: u32 planes
    a = [u32(t) if i == pix else t.numpy() for i, t in enumerate(args)]
    if mode == "general":
        return np.asarray(J.compose_frame(jnp.asarray(prev), *(
            jnp.asarray(x) for x in a)))
    if mode == "fused":
        bts, mv, rect, payload = (jnp.asarray(x)[None] for x in a)
        frames, _ = JP.decode_sequence_fused(
            jnp.asarray(prev), bts, mv, rect, payload, jnp.ones(1, bool),
            jnp.int32(0), interpret=True)
        return np.asarray(frames[0])
    return np.asarray(JM.compose_frame_mxu_safe(
        jnp.asarray(prev), *(jnp.asarray(x) for x in a), interpret=True))


@pytest.mark.parametrize("case,mode", [
    (c, m) for c in sorted(BLOCK_CASES) for m in MODES
    if reference_takes(c, m)])
def test_block_case_vs_reference(case, mode):
    """The case through the port's wrapper on the CPU (its plain twin, in
    the case's layout) against the JAX package stream by stream; an
    unchanged stream keeps prev."""
    prev, args, chg, got = run_case(case, mode, "cpu")
    for b in range(prev.shape[0]):
        want = u32(prev[b])
        if chg[b]:
            want = reference_step(mode, want, [a[b] for a in args])
        np.testing.assert_array_equal(u32(got[b]), want, err_msg=f"{b}")

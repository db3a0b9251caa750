"""The port's CUDA kernels against their plain twins, on the card.

Marked ``cuda``: they skip where torch.cuda.is_available() is False (as on
a CPU-only test host) and run on a GPU machine with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(--noconftest: tests/conftest.py imports jax, which the GPU machine
need not have; nothing here imports it.)

The kernels build from jsplayer_tpu_torch/csrc/ at first use."""

import numpy as np
import pytest
import torch

from test_torch_bc_cases import BC_CASES, run_bc_case
from test_torch_block_cases import BLOCK_CASES, MODES, case_fns, run_case, \
    rows_view
from test_torch_lane_cases import LANE_CASES, run_lane_case
from test_torch_msv1_cases import MSV1_CASES, run_msv1_case, vector_path
from test_torch_payload_cases import PAYLOAD_CASES
from test_torch_sparse_cases import SPARSE_CASES, SPARSE_SEQUENCES, \
    run_sparse_case
from test_torch_rans_cases import RANS_CASES, offset_view, rans_case_inputs

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def rand_u32(shape, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(a.view(np.int32))


@pytest.mark.parametrize("shape", [(1, 2, 2), (3, 7, 9), (2, 33, 130),
                                   (4, 1080, 1920)])
@pytest.mark.parametrize("flip", [False, True])
def test_ds2_pack_kernel(dev, shape, flip):
    from jsplayer_tpu_torch.kernels.rgb_convert import ds2_pack, ds2_pack_ref

    f = rand_u32(shape, seed=sum(shape)).to(dev)
    before = ds2_pack.launches
    got = ds2_pack(f, flip=flip)
    assert ds2_pack.launches == before + 1
    torch.testing.assert_close(got, ds2_pack_ref(f, flip=flip), rtol=0,
                               atol=0)


@pytest.mark.parametrize("B,K", [(1, 1), (4, 2), (3, 8)])
def test_kmv_compose_kernel(dev, B, K):
    from jsplayer_tpu_torch.kernels.sp_recon import kmv_compose, kmv_compose_ref

    Y, X = 48, 80
    rng = np.random.default_rng(B * 10 + K)
    prev = rand_u32((B, Y, X), seed=K).to(dev)
    word = (rng.integers(0, 1 << 24, (B, Y, X), dtype=np.uint32)
            | (rng.integers(0, 4, (B, Y, X), dtype=np.uint32) << 24)
            | (rng.integers(0, 8, (B, Y, X), dtype=np.uint32) << 26))
    pc = torch.from_numpy(word.view(np.int32)).to(dev)
    mvk = torch.from_numpy(
        rng.integers(-3 * X, 3 * X, (B, K, 2)).astype(np.int32)).to(dev)
    chg = torch.from_numpy(np.arange(B) % 3 != 1).to(dev)
    torch.testing.assert_close(kmv_compose(prev, pc, mvk, chg),
                               kmv_compose_ref(prev, pc, mvk, chg),
                               rtol=0, atol=0)


def test_kmv_compose_rejects_aliased_out(dev):
    from jsplayer_tpu_torch.kernels.sp_recon import kmv_compose

    prev = torch.zeros((2, 16, 16), dtype=torch.int32, device=dev)
    mvk = torch.zeros((2, 2, 2), dtype=torch.int32, device=dev)
    chg = torch.ones(2, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="alias"):
        kmv_compose(prev, prev.clone(), mvk, chg, out=prev)


def stills_avi(seed, nframes=12, X=48, Y=32):
    """A keyframe, then mostly stills with sparse paints and scrolls."""
    from jsplayer_tpu_torch.encode.avi_mux import mux_avi
    from jsplayer_tpu_torch.encode.sp_enc import ScreenPressorEncoder, pack_rgb

    rng = np.random.default_rng(seed)
    enc = ScreenPressorEncoder(4, X, Y)
    f = np.full((Y, X), pack_rgb(seed, 50, 90), dtype=np.uint32)
    chunks = []
    for t in range(nframes):
        f = f.copy()
        if t % 3 == 1:
            f[2:, :] = f[:-2, :].copy()
        if t % 4 == 2:
            f[(t % 6) * 4:(t % 6) * 4 + 4, 4:24] = pack_rgb(
                *rng.integers(0, 256, 3))
        flat = f.reshape(-1)
        chunks.append(enc.encode_i(flat) if t in (0, 7) else
                      enc.encode_p(flat))
    return mux_avi(chunks, X, Y, 24, codec="SPV4",
                   keyflags=[t in (0, 7) for t in range(nframes)])


@pytest.mark.parametrize("emit_frames", [True, False])
def test_ingest_cuda_matches_cpu(dev, emit_frames):
    from jsplayer_tpu_torch.core.source import MemorySource
    from jsplayer_tpu_torch.pipeline import ingest as P

    avis = [stills_avi(s) for s in (3, 7, 11)]
    kw = dict(window=5, still_elision=True, model_downscale=2,
              emit_frames=emit_frames)
    outs, stats = {}, {}
    for d in ("cpu", "cuda"):
        pipe = P.VideoIngestPipeline([MemorySource(a) for a in avis],
                                     P.IngestConfig(device=d, **kw))
        outs[d] = list(pipe)
        stats[d] = pipe.stats
    assert stats["cuda"] == stats["cpu"]
    assert stats["cpu"]["concat_windows"] and stats["cpu"]["padded_windows"]
    for a, b in zip(outs["cpu"], outs["cuda"]):
        assert a.keys() == b.keys()
        for k, v in a.items():
            if isinstance(v, torch.Tensor):
                assert torch.equal(v, b[k].cpu()), k
            else:
                np.testing.assert_array_equal(np.asarray(v), np.asarray(b[k]))


@pytest.mark.parametrize("transport", ["kmv", "bc"])
@pytest.mark.parametrize("cards", [0, 1, 2])
def test_pinned_pool_refill_waits_for_held_back_copies(dev, monkeypatch,
                                                       transport, cards):
    """Elided windows back to back through the pinned pool (one card, or a
    dp=2 mesh with both slots on cuda:0 or on two cards), each window's
    plane copies held back behind a long kernel queued ahead of them
    (torch.cuda._sleep): a refill wait found copies still in flight, every
    fill of the plane came after all of them had read it, and the frames
    and model tensors equal the same pipeline's on the CPU bit for bit.
    upload.pinned_bytes is the direct rows' planes."""
    from jsplayer_tpu_torch import native
    from jsplayer_tpu_torch.core.source import MemorySource
    from jsplayer_tpu_torch.pipeline import ingest as P
    from jsplayer_tpu_torch.pipeline import mesh as PM
    from jsplayer_tpu_torch.utils.logging import LOG

    if cards == 2 and torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    avis = [stills_avi(s) for s in (3, 7, 11, 5)]
    kw = dict(window=5, still_elision=True, model_downscale=2,
              sp_device_path=transport)
    guards, in_flight, early = [], [], []
    raw_rows, raw_guard = P.upload_changed_rows, P.upload_guard
    decode = {"kmv": "decompress_kmv", "bc": "decompress_bc"}[transport]
    raw_decode = getattr(native.NativeScreenPressor, decode)

    class Watched:
        def __init__(self, ev):
            self.ev = ev

        def synchronize(self):
            in_flight.append(not self.ev.query())
            self.ev.synchronize()

    def held_back(pc, rows, counts, device, cpad=None):
        with torch.cuda.device(device):
            torch.cuda._sleep(200_000_000)
        return raw_rows(pc, rows, counts, device, cpad)

    def guard(device):
        guards.append(Watched(raw_guard(device)))
        return guards[-1]

    def fill(self, *a, **k):
        early.extend(g for g in guards if not g.ev.query())
        return raw_decode(self, *a, **k)

    outs = {}
    for d in ("cpu", "cuda"):
        if d == "cuda":
            monkeypatch.setattr(P, "upload_changed_rows", held_back)
            monkeypatch.setattr(P, "upload_guard", guard)
            monkeypatch.setattr(native.NativeScreenPressor, decode, fill)
        mesh = None if not cards else PM.make_mesh(
            2, 1, devices=[torch.device(d, k % cards) if d == "cuda"
                           else torch.device("cpu") for k in range(2)])
        before = LOG.counters.copy()
        pipe = P.VideoIngestPipeline([MemorySource(a) for a in avis],
                                     P.IngestConfig(device=d, mesh=mesh,
                                                    **kw))
        outs[d] = list(pipe)
        got = LOG.counters - before
    assert pipe._sp_native and len(outs["cuda"]) == 3
    assert len(guards) == (2 if cards else 1) * len(outs["cuda"])
    assert any(in_flight) and not early
    for a, b in zip(outs["cpu"], outs["cuda"]):
        assert a.keys() == b.keys()
        for k, v in a.items():
            if isinstance(v, torch.Tensor):
                assert torch.equal(v, b[k].cpu()), k
            else:
                np.testing.assert_array_equal(np.asarray(v), np.asarray(b[k]))
    assert got["upload.pinned_bytes"] == (got["elision.direct_rows"]
                                          * 48 * 32 * 4) > 0


@pytest.mark.parametrize("layout", ["concat", "padded"])
def test_changed_rows_upload_matches_the_host_stack(dev, layout):
    """The elided route's device stack, placed run by run from a window of
    random 1080p paycode planes, equals to_device of compact_changed_batch's
    host stack bit for bit (CONCAT: its real rows back to back), the pad
    rows zero though the allocator hands out dirty memory."""
    from jsplayer_tpu_torch.device import to_device
    from jsplayer_tpu_torch.kernels.sp_recon import compact_changed_batch
    from jsplayer_tpu_torch.pipeline.ingest import upload_changed_rows

    B, T, Y, X, K = 3, 6, 1080, 1920, 2
    rng = np.random.default_rng(18)
    pc = rng.integers(0, 1 << 32, (B, T, Y, X), dtype=np.uint32)
    mvk = rng.integers(-64, 64, (B, T, K, 2)).astype(np.int32)
    changed = np.array([[1, 1, 0, 1, 0, 1], [0, 0, 0, 0, 0, 0],
                        [1, 1, 1, 1, 1, 0]], dtype=bool)
    pcc, _, valid, _ = compact_changed_batch(pc, mvk, changed)
    rows, _, _, _ = compact_changed_batch(np.tile(np.arange(T), (B, 1)),
                                          mvk, changed)
    counts = valid.sum(axis=1)
    if layout == "concat":
        want = to_device(np.concatenate([pcc[b, :counts[b]]
                                         for b in range(B)]), dev)
        cpad = None
    else:
        want, cpad = to_device(pcc, dev), pcc.shape[1]
    # dirty blocks for torch.empty to reuse
    junk = torch.full((2 * want.numel(),), -1, dtype=torch.int32,
                      device=dev)
    del junk
    got = upload_changed_rows(pc, rows, counts, dev, cpad)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.device == want.device
    assert torch.equal(got, want)
    if cpad is not None:
        for b in range(B):
            assert not got[b, counts[b]:].any()


def block_commands(B, Y, X, seed, mv_range):
    """Random SP block commands for one step of B streams (bts -1..7,
    vectors of up to mv_range pixels, rects across their block)."""
    rng = np.random.default_rng(seed)
    nby, nbx = (Y + 15) // 16, (X + 15) // 16
    nb = nby * nbx
    bts = rng.integers(-1, 8, (B, nb)).astype(np.int32)
    mv = rng.integers(-mv_range, mv_range + 1, (B, nb, 2)).astype(np.int32)
    bx = (np.arange(nb) % nbx) * 16
    by = (np.arange(nb) // nbx) * 16
    x0 = bx + rng.integers(-2, 10, (B, nb))
    y0 = by + rng.integers(-2, 10, (B, nb))
    rect = np.stack([x0, y0, x0 + rng.integers(0, 12, (B, nb)),
                     y0 + rng.integers(0, 12, (B, nb))], -1).astype(np.int32)
    return [torch.from_numpy(a) for a in (bts, mv, rect)]


def mode_inputs(mode, B, Y, X, seed, mv_range):
    """(step, plain twin, argument tensors on the CPU) of one mode."""
    from jsplayer_tpu_torch.kernels import sp_motion_mxu as PM
    from jsplayer_tpu_torch.kernels import sp_motion_pallas as PP
    from jsplayer_tpu_torch.kernels import sp_recon as P

    bts, mv, rect = block_commands(B, Y, X, seed, mv_range)
    payload = rand_u32((B, Y, X), seed=seed + 1)
    if mode == "mxu":
        cmds = [PM.mxu_commands(bts[b], mv[b], rect[b], payload[b])
                for b in range(B)]
        pc, src, im = (torch.stack(c) for c in zip(*cmds))
        pc = pc ^ (rand_u32((B, Y, X), seed=seed + 2) & (0xFF << 24))
        im = im + (bts == 4).to(torch.int32)  # is_motion 1 and 2
        return PM.sp_motion_mxu, PM.compose_frame_mxu_ref, [pc, src, im]
    if mode == "general":
        return P.sp_compose_general, P.compose_frame_ref, [
            bts, mv, rect, payload]
    return PP.sp_motion_patch, PP.compose_frame_fast_ref, [
        bts, mv, rect, payload]


@pytest.mark.parametrize("mode", ["general", "fused", "mxu"])
@pytest.mark.parametrize("B,Y,X,mv_range", [
    (1, 16, 16, 4), (3, 40, 56, 30), (2, 33, 130, 300), (4, 1080, 1920, 40)])
def test_block_kernel_modes(dev, mode, B, Y, X, mv_range):
    """Each mode of csrc/sp_motion.cu against its plain twin, written into
    a strided slot of a stack whose other slots stay untouched, with one
    stream unchanged (its commands are garbage and must not be read)."""
    from jsplayer_tpu_torch.kernels.sp_recon import per_stream_ref

    step, ref, args = mode_inputs(mode, B, Y, X, B * 100 + Y, mv_range)
    prev = rand_u32((B, Y, X), seed=X) & 0x00FFFFFF
    chg = torch.from_numpy(np.arange(B) % 3 != 1)
    want = per_stream_ref(ref, prev, chg, *args)
    stack = torch.full((B, 3, Y, X), 0x7EADBEEF, dtype=torch.int32,
                       device=dev)
    before = step.launches
    step(prev.to(dev), *(a.to(dev) for a in args), chg.to(dev),
         out=stack[:, 1])
    torch.cuda.synchronize()
    assert step.launches == before + 1
    got = stack.cpu()
    torch.testing.assert_close(got[:, 1], want, rtol=0, atol=0)
    assert (got[:, 0] == 0x7EADBEEF).all() and (got[:, 2] == 0x7EADBEEF).all()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_block_kernel_cases(dev, mode, case):
    """Each mode of csrc/sp_motion.cu against its plain twin, bit for bit,
    on the shapes, layouts and commands that pick each path of the kernel
    (tests/test_torch_block_cases.py BLOCK_CASES): X % 4 != 0, odd Y and
    X, Y % 16 != 0, offset and odd-stride views (4-byte path), a
    frames[:, t] window view (16-byte path), rects that split vectors, bts
    -1..7, aligned and unaligned motion, sources outside every edge,
    unchanged streams with garbage commands, B = 1 and 5."""
    from jsplayer_tpu_torch.kernels.sp_recon import per_stream_ref

    prev, args, chg, got = run_case(case, mode, dev)
    torch.cuda.synchronize()
    want = per_stream_ref(case_fns(mode)[1], prev, chg, *args)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["general", "fused", "mxu"])
def test_block_kernel_rejects_aliased_out(dev, mode):
    step, _, args = mode_inputs(mode, 2, 16, 16, 0, 4)
    prev = torch.zeros((2, 16, 16), dtype=torch.int32, device=dev)
    chg = torch.ones(2, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="alias"):
        step(prev, *(a.to(dev) for a in args), chg, out=prev)


@pytest.mark.parametrize("path", ["general", "pallas"])
def test_block_command_ingest_cuda_matches_cpu(dev, path):
    from jsplayer_tpu_torch.core.source import MemorySource
    from jsplayer_tpu_torch.pipeline import ingest as P

    avis = [stills_avi(s) for s in (3, 7, 11)]
    kw = dict(window=5, sp_device_path=path, model_downscale=2)
    outs = {}
    for d in ("cpu", "cuda"):
        pipe = P.VideoIngestPipeline([MemorySource(a) for a in avis],
                                     P.IngestConfig(device=d, **kw))
        outs[d] = list(pipe)
    assert len(outs["cpu"]) == len(outs["cuda"]) > 1
    for a, b in zip(outs["cpu"], outs["cuda"]):
        assert a.keys() == b.keys()
        for k, v in a.items():
            if isinstance(v, torch.Tensor):
                assert torch.equal(v, b[k].cpu()), k
            else:
                assert v == b[k], k


def kmv_step_inputs(B, Y, X, K, seed):
    """prev, paycode (every ptype and kslot), wrapping vectors and a
    changed mask with one unchanged stream, on the CPU."""
    rng = np.random.default_rng(seed)
    prev = rand_u32((B, Y, X), seed=seed + 1)
    word = (rng.integers(0, 1 << 24, (B, Y, X), dtype=np.uint32)
            | (rng.integers(0, 4, (B, Y, X), dtype=np.uint32) << 24)
            | (rng.integers(0, 8, (B, Y, X), dtype=np.uint32) << 26))
    mvk = rng.integers(-3 * X, 3 * X, (B, K, 2)).astype(np.int32)
    chg = np.arange(B) % 3 != 1
    return (prev, torch.from_numpy(word.view(np.int32)),
            torch.from_numpy(mvk), torch.from_numpy(chg))


@pytest.mark.parametrize("B,Y,X,K", [(1, 16, 16, 1), (4, 48, 80, 2),
                                     (3, 33, 71, 8), (2, 5, 1, 2),
                                     (2, 1080, 1920, 2)])
def test_kmv_compose_ds2_kernel(dev, B, Y, X, K):
    """The fused compose+ds2 instance against kmv_compose_ref + ds2_pack_ref,
    written into strided slots of stacks whose other slots stay untouched
    (odd Y and X: the last row/column composes and gets no ds2 word)."""
    from jsplayer_tpu_torch.kernels.sp_recon import (kmv_compose_ds2,
                                                     kmv_compose_ds2_ref)

    args = kmv_step_inputs(B, Y, X, K, seed=B * 7 + Y)
    want_out, want_red = kmv_compose_ds2_ref(*args)
    fill = 0x7EADBEEF
    frames = torch.full((B, 3, Y, X), fill, dtype=torch.int32, device=dev)
    reds = torch.full((B, 3, Y // 2, X // 2), fill, dtype=torch.int32,
                      device=dev)
    before = kmv_compose_ds2.launches
    out, red = kmv_compose_ds2(*(a.to(dev) for a in args), out=frames[:, 1],
                               red=reds[:, 1])
    torch.cuda.synchronize()
    assert kmv_compose_ds2.launches == before + 1
    assert out.data_ptr() == frames[:, 1].data_ptr()
    torch.testing.assert_close(frames[:, 1].cpu(), want_out, rtol=0, atol=0)
    torch.testing.assert_close(reds[:, 1].cpu(), want_red, rtol=0, atol=0)
    for s in (0, 2):
        assert (frames[:, s] == fill).all() and (reds[:, s] == fill).all()


# name → (B, Y, X, K, mvk rows or None for random, changed, view offset/pad)
KMV_CASES = {
    "x_not_4": (3, 48, 70, 2, None, [True, False, True], None),
    "odd_y_x": (2, 33, 71, 3, None, [True, True], None),
    "unaligned_view": (3, 40, 64, 2, None, [True, True, False], (1, 3)),
    "odd_plane_stride": (2, 40, 64, 2, None, [True, True], (0, 2)),
    "out_of_frame": (4, 56, 80, 2, [[[3, -5], [-7, 2]],
                                    [[-2000, 1500], [1925, -1085]],
                                    [[16, 16], [-16, 0]],
                                    [[0, 56], [-80, -2 * 56 - 1]]],
                     [True, True, False, True], None),
    "all_unchanged": (2, 32, 64, 2, None, [False, False], None),
    "k0": (2, 48, 80, 0, None, [True, True], None),
    "k8": (3, 48, 80, 8, None, [True, False, True], None),
    "k8_odd": (2, 37, 45, 8, None, [True, True], (1, 1)),
}


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("case", sorted(KMV_CASES))
def test_kmv_compose_cases(dev, fused, case):
    """kmv_compose and kmv_compose_ds2 against their plain twins, bit for
    bit, on the shapes and inputs that pick each path of the kernel: X % 4
    != 0 and odd Y, X (scalar path), views whose rows are not 16-byte
    aligned (scalar path) or aligned (vector path), out-of-frame and |mv| >=
    Y, X vectors, unchanged streams, K = 0 and K = 8."""
    from jsplayer_tpu_torch.kernels.sp_recon import (kmv_compose,
                                                     kmv_compose_ds2,
                                                     kmv_compose_ds2_ref,
                                                     kmv_compose_ref)

    B, Y, X, K, rows, chg, view = KMV_CASES[case]
    prev, pc, mvk, _ = kmv_step_inputs(B, Y, X, K, seed=len(case) * 31 + K)
    if rows is not None:
        mvk = torch.tensor(rows, dtype=torch.int32)
    chg = torch.tensor(chg)
    args = [prev.to(dev), pc.to(dev), mvk.to(dev), chg.to(dev)]
    if view is not None:
        args[0], args[1] = rows_view(args[0], *view), rows_view(args[1], *view)
    step, ref = ((kmv_compose_ds2, kmv_compose_ds2_ref) if fused
                 else (kmv_compose, kmv_compose_ref))
    before = step.launches
    got = step(*args)
    want = ref(prev, pc, mvk, chg)
    torch.cuda.synchronize()
    assert step.launches == before + 1
    for g, w in zip(got, want) if fused else [(got, want)]:
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)


def test_kmv_compose_ds2_rejects_aliased_out(dev):
    from jsplayer_tpu_torch.kernels.sp_recon import kmv_compose_ds2

    prev = torch.zeros((2, 16, 16), dtype=torch.int32, device=dev)
    mvk = torch.zeros((2, 2, 2), dtype=torch.int32, device=dev)
    chg = torch.ones(2, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="alias"):
        kmv_compose_ds2(prev, prev.clone(), mvk, chg, out=prev)


DS_PROBE_MODES = ["ds2_fields", "bitcast_fold", "passthru", "pack_h", "sum4",
                  "hpair_i32", "hpair_lowbyte", "wpair_i32", "block_transpose"]


@pytest.mark.parametrize("mode", DS_PROBE_MODES)
@pytest.mark.parametrize("C,Y,X,BH", [(1, 16, 16, 16), (2, 40, 256, 16),
                                      (3, 33, 70, 8), (2, 37, 45, 12),
                                      (2, 9, 1, 4), (4, 1080, 1920, 128)])
def test_ds_probe_kernel(dev, mode, C, Y, X, BH):
    """Each ds_probe mode against its plain twin, written into a strided
    slot of a stack whose other slots stay untouched: Y not a multiple of
    BH (a partial last block reads 0 past Y), odd Y and X."""
    from jsplayer_tpu_torch.experiments.probes import probe_ref, probe_shape
    from jsplayer_tpu_torch.kernels.ds_probe import ds_probe

    f = rand_u32((C, Y, X), seed=C * 1000 + Y + X)
    if mode == "bitcast_fold" and X % 2:
        with pytest.raises(ValueError, match="even"):
            ds_probe(f.to(dev), mode, BH)
        return
    want = probe_ref(f, mode, BH)
    _, Ho, Wo = probe_shape(mode, C, Y, X, BH)
    fill = 0x7EADBEEF
    stack = torch.full((C, 3, Ho, Wo), fill, dtype=torch.int32, device=dev)
    before = ds_probe.by_mode[mode]
    got = ds_probe(f.to(dev), mode, BH, out=stack[:, 1])
    torch.cuda.synchronize()
    # an empty output (X=1 → Wo=0) launches nothing
    assert ds_probe.by_mode[mode] == before + int(Ho * Wo > 0)
    assert got.data_ptr() == stack[:, 1].data_ptr()
    torch.testing.assert_close(stack[:, 1].cpu(), want, rtol=0, atol=0)
    assert (stack[:, 0] == fill).all() and (stack[:, 2] == fill).all()


@pytest.mark.parametrize("C,Y,X,BH,offset", [
    (1, 130, 1000, 128, 0), (5, 37, 45, 12, 0), (2, 300, 130, 128, 1),
    (3, 64, 260, 32, 2), (1, 1080, 1920, 128, 1), (5, 200, 96, 8, 0)])
def test_block_transpose_odd_shapes(dev, C, Y, X, BH, offset):
    """block_transpose against its twin where Y is not a multiple of BH, X
    not a multiple of 4 or of the kernel's 128-column tile, C = 1 and 5, BH
    below the 32-row tile, and frames viewed `offset` words into a buffer
    (the 4-byte path) with an output slot between untouched ones."""
    from jsplayer_tpu_torch.experiments.probes import probe_ref, probe_shape
    from jsplayer_tpu_torch.kernels.ds_probe import ds_probe

    f = rand_u32((C, Y, X), seed=C * 7 + Y + X)
    want = probe_ref(f, "block_transpose", BH)
    frames = rows_view(f.to(dev), offset, 0)
    _, Ho, Wo = probe_shape("block_transpose", C, Y, X, BH)
    fill = 0x7EADBEEF
    stack = torch.full((C, 3, Ho, Wo), fill, dtype=torch.int32, device=dev)
    before = ds_probe.by_mode["block_transpose"]
    ds_probe(frames, "block_transpose", BH, out=stack[:, 1])
    torch.cuda.synchronize()
    assert ds_probe.by_mode["block_transpose"] == before + 1
    torch.testing.assert_close(stack[:, 1].cpu(), want, rtol=0, atol=0)
    assert (stack[:, 0] == fill).all() and (stack[:, 2] == fill).all()


#: (C, Y, X, BH, offset, pad) → the instance passthru, hpair_i32 and
#: wpair_i32 take
ROW_MODES = ("passthru", "hpair_i32", "wpair_i32")
ROW_MODE_CASES = {
    (2, 1080, 1920, 128, 0, 0): ("vec", "vec", "vec"),
    (1, 1080, 1920, 128, 1, 0): ("scalar", "scalar", "scalar"),
    (1, 130, 1000, 128, 0, 0): ("vec", "vec", "vec"),
    (65, 37, 45, 12, 0, 0): ("scalar", "scalar", "scalar"),
    (2, 300, 132, 128, 0, 0): ("scalar", "vec", "scalar"),
    (3, 64, 264, 32, 1, 0): ("scalar", "scalar", "scalar"),
    (2, 64, 264, 32, 0, 1): ("scalar", "scalar", "scalar"),
    (4, 10, 64, 32, 0, 0): ("vec", "vec", "vec"),
    (5, 200, 96, 8, 0, 0): ("vec", "vec", "vec"),
    (3, 50, 40, 4, 0, 0): ("vec", "vec", "vec"),
    (65, 30, 24, 12, 0, 0): ("vec", "vec", "vec"),
    (4, 37, 1920, 128, 0, 0): ("vec", "vec", "vec"),
    (1, 20, 9000, 16, 0, 0): ("vec", "vec", "vec"),
    (1, 20, 9002, 16, 0, 0): ("scalar", "scalar", "scalar"),
    (2, 77, 1921, 64, 0, 0): ("scalar", "scalar", "scalar"),
    (3, 1024, 1924, 128, 0, 0): ("scalar", "vec", "scalar"),
}


@pytest.mark.parametrize("mode", ROW_MODES)
@pytest.mark.parametrize("case", list(ROW_MODE_CASES))
def test_row_modes_odd_shapes(dev, mode, case):
    """The row modes (ds_probe.cu's rows_kernel) against their twins, bit
    for bit, and the instance that ran: Y not a multiple of BH, Y odd and
    Y < BH/2 (zero rows, a last row pair with one row past Y), X odd, X/2
    not a multiple of 4, BH = 4, 8, 12, C = 1 and 65, rows wider than one
    pass of the block's threads, frames viewed `offset` words into a
    buffer or `pad` words apart (the 4-byte instance), and an output slot
    between untouched ones."""
    from jsplayer_tpu_torch.experiments.probes import probe_ref, probe_shape
    from jsplayer_tpu_torch.kernels.ds_probe import ds_probe

    C, Y, X, BH, offset, pad = case
    instance = ROW_MODE_CASES[case][ROW_MODES.index(mode)]
    f = rand_u32((C, Y, X), seed=C * 11 + Y + X)
    want = probe_ref(f, mode, BH)
    frames = rows_view(f.to(dev), offset, pad)
    _, Ho, Wo = probe_shape(mode, C, Y, X, BH)
    fill = 0x7EADBEEF
    stack = torch.full((C, 3, Ho, Wo), fill, dtype=torch.int32, device=dev)
    before = ds_probe.by_instance[mode][instance]
    ds_probe(frames, mode, BH, out=stack[:, 1])
    torch.cuda.synchronize()
    assert ds_probe.last_instance == instance
    assert ds_probe.by_instance[mode][instance] == before + 1
    torch.testing.assert_close(stack[:, 1].cpu(), want, rtol=0, atol=0)
    assert (stack[:, 0] == fill).all() and (stack[:, 2] == fill).all()


@pytest.mark.parametrize("case", sorted(BC_CASES))
def test_bc_kernel_cases(dev, case):
    """csrc/bc_compose.cu against its plain twin, bit for bit, on the
    shapes, layouts and commands that pick each path of the kernel
    (tests/test_torch_bc_cases.py BC_CASES): X % 4 != 0, odd Y and X,
    Y % 16 != 0, offset and odd-stride views (4-byte path), window views
    (16-byte path), rloc rows off a 4-byte boundary, split and whole rects,
    codes past the motion slots, wrapping vectors, K = 0 and 8, unchanged
    streams with garbage commands, B = 1 and 5."""
    from jsplayer_tpu_torch.kernels.sp_recon import bc_compose_ref

    prev, args, chg, got = run_bc_case(case, dev)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, bc_compose_ref(prev, *args, chg),
                               rtol=0, atol=0)


def test_bc_kernel_never_uses_the_plane_outside_data_rects(dev):
    """Inverting every plane word outside the code-1 rects leaves a B=4
    1080p step unchanged."""
    from jsplayer_tpu_torch.experiments.common import bc_data_pixels
    from jsplayer_tpu_torch.kernels.sp_recon import bc_compose, bc_compose_ref

    B, Y, X, K = 4, 1080, 1920, 2
    rng = np.random.default_rng(4)
    nb = ((Y + 15) // 16) * ((X + 15) // 16)
    prev, plane = rand_u32((B, Y, X), 1).to(dev), rand_u32((B, Y, X), 2)
    bcode = torch.from_numpy(rng.integers(0, K + 3, (B, nb)).astype(np.uint8))
    rloc = rng.integers(0, 21, (B, nb, 4)).astype(np.uint8)
    rloc[rng.random((B, nb)) < 0.5] = (0, 0, 16, 16)
    rloc = torch.from_numpy(rloc)
    mvk = torch.from_numpy(rng.integers(-3 * X, 3 * X, (B, K, 2))
                           .astype(np.int32))
    keep = torch.stack([bc_data_pixels(bcode[b], rloc[b], Y, X)
                        for b in range(B)])
    flipped = torch.where(keep, plane, ~plane)
    chg = torch.tensor([True, True, False, True], device=dev)
    args = [a.to(dev) for a in (bcode, rloc, mvk)]
    got = bc_compose(prev, plane.to(dev), *args, chg)
    again = bc_compose(prev, flipped.to(dev), *args, chg)
    want = bc_compose_ref(prev, plane.to(dev), *args, chg)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(again, want)


def test_bc_kernel_rejects_aliased_out_and_wrong_types(dev):
    from jsplayer_tpu_torch.kernels.sp_recon import bc_compose

    prev = torch.zeros((2, 16, 16), dtype=torch.int32, device=dev)
    bcode = torch.zeros((2, 1), dtype=torch.uint8, device=dev)
    rloc = torch.zeros((2, 1, 4), dtype=torch.uint8, device=dev)
    mvk = torch.zeros((2, 2, 2), dtype=torch.int32, device=dev)
    chg = torch.ones(2, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="alias"):
        bc_compose(prev, prev.clone(), bcode, rloc, mvk, chg, out=prev)
    with pytest.raises(TypeError, match="uint8"):
        bc_compose(prev, prev.clone(), bcode.int(), rloc, mvk, chg)
    with pytest.raises(ValueError, match="rloc"):
        bc_compose(prev, prev.clone(), bcode, rloc[:, :, :2], mvk, chg)


@pytest.mark.parametrize("kw", [
    dict(still_elision=True, model_downscale=2),
    dict(still_elision=True, emit_frames=False, model_downscale=2),
    dict(emit_frames=False, model_downscale=2),
    dict(model_downscale=2, model_packed=True, emit_frames=False)])
def test_bc_ingest_cuda_matches_cpu(dev, kw):
    """The bc path on the card against the same pipeline on the CPU (the
    plain twins): elided (CONCAT and PADDED), dense model-only and packed."""
    from jsplayer_tpu_torch.core.source import MemorySource
    from jsplayer_tpu_torch.pipeline import ingest as P

    avis = [stills_avi(s) for s in (3, 7, 11)]
    if kw.get("model_packed"):
        avis = avis[:1]
    outs, stats = {}, {}
    for d in ("cpu", "cuda"):
        pipe = P.VideoIngestPipeline(
            [MemorySource(a) for a in avis],
            P.IngestConfig(device=d, window=5, sp_device_path="bc", **kw))
        outs[d] = list(pipe)
        stats[d] = pipe.stats
    assert stats["cuda"] == stats["cpu"]
    if kw.get("still_elision"):
        assert stats["cpu"]["concat_windows"] and \
            stats["cpu"]["padded_windows"]
    assert len(outs["cpu"]) == len(outs["cuda"]) > 1
    for a, b in zip(outs["cpu"], outs["cuda"]):
        assert a.keys() == b.keys()
        for k, v in a.items():
            if isinstance(v, torch.Tensor):
                assert torch.equal(v, b[k].cpu()), k
            else:
                np.testing.assert_array_equal(np.asarray(v), np.asarray(b[k]))


def test_validate_legs_on_the_card(dev):
    from jsplayer_tpu_torch import validate

    assert validate.run("cuda") == {leg: True for leg in validate.LEGS}


@pytest.mark.parametrize("case", sorted(LANE_CASES))
def test_lane_kernel_cases(dev, case):
    """csrc/bc_compose.cu's lane instance against its plain twin, bit for
    bit, on the shapes, layouts, commands and row indices that pick each
    path of the kernel (tests/test_torch_lane_cases.py LANE_CASES): X % 4
    != 0, odd Y and X, offset and odd-stride views, wide and odd-stride
    rows, indices that wrap or fall outside the rows, top-byte rows, split
    and whole rects, codes past the motion slots, wrapping vectors, K = 0
    and 8, unchanged streams with garbage commands, B = 1 and 5."""
    from jsplayer_tpu_torch.kernels.lane_recon import lane_compose_ref

    prev, args, chg, got = run_lane_case(case, dev)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, lane_compose_ref(prev, *args, chg),
                               rtol=0, atol=0)


def test_lane_kernel_rejects_aliased_out_and_wrong_types(dev):
    from jsplayer_tpu_torch.kernels.lane_recon import lane_compose

    prev = torch.zeros((2, 16, 16), dtype=torch.int32, device=dev)
    rows = torch.zeros((2, 3, 16), dtype=torch.int32, device=dev)
    ri = torch.zeros((2, 16), dtype=torch.int32, device=dev)
    bcode = torch.zeros((2, 1), dtype=torch.uint8, device=dev)
    rloc = torch.zeros((2, 1, 4), dtype=torch.uint8, device=dev)
    mvk = torch.zeros((2, 2, 2), dtype=torch.int32, device=dev)
    chg = torch.ones(2, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="alias"):
        lane_compose(prev, rows, ri, bcode, rloc, mvk, chg, out=prev)
    with pytest.raises(TypeError, match="uint8"):
        lane_compose(prev, rows, ri, bcode.int(), rloc, mvk, chg)
    with pytest.raises(ValueError, match="row_idx"):
        lane_compose(prev, rows, ri[:, :8], bcode, rloc, mvk, chg)
    with pytest.raises(IndexError):
        lane_compose(prev, rows[:, :0], ri, bcode, rloc, mvk, chg)


def rans_inputs(B, N, steps, L, seed, dists=("skewed", "peaked", "pad")):
    """Random u32 states (0 and >= 2^31 among them), refills and lane bytes,
    a table a stream from the uniform/skewed/peaked/pad set, on the CPU."""
    from test_torch_rans_cases import tables, u32_states

    rng = np.random.default_rng(seed)
    freq = np.stack([tables(dists[b % len(dists)]) for b in range(B)])
    states = np.stack([u32_states(rng, N) for _ in range(B)])
    refills = rng.integers(0, 256, (B, steps, N, 2), dtype=np.uint8)
    lanes = rng.integers(0, 256, (B, N, L), dtype=np.uint8)
    return (torch.from_numpy(refills), torch.from_numpy(lanes),
            torch.from_numpy(states.view(np.int32)), torch.from_numpy(freq))


@pytest.mark.parametrize("B,N,steps,L", [
    (1, 1, 9, 3), (3, 8, 17, 0), (2, 64, 40, 11), (4, 130, 33, 25),
    (4, 4096, 70, 60)])
def test_rans_kernels_random(dev, B, N, steps, L):
    """Both decodes against their twins on random u32 states, refills and
    lane bytes (reads past a lane's bytes; L = 0), N not a multiple of the
    block, steps not a multiple of the kernel's look-ahead."""
    from jsplayer_tpu_torch.kernels.rans_lanes import (
        rans_decode_aligned, rans_decode_aligned_ref, rans_decode_packed,
        rans_decode_packed_ref)

    refills, lanes, states, freq = rans_inputs(B, N, steps, L, B * N + L)
    before = (rans_decode_aligned.launches, rans_decode_packed.launches)
    got_a = rans_decode_aligned(*(t.to(dev) for t in (refills, states, freq)))
    got_p = rans_decode_packed(*(t.to(dev) for t in (lanes, states, freq)),
                               steps)
    torch.cuda.synchronize()
    assert (rans_decode_aligned.launches, rans_decode_packed.launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(got_a.cpu(), rans_decode_aligned_ref(refills, states,
                                                            freq))
    assert torch.equal(got_p.cpu(), rans_decode_packed_ref(lanes, states,
                                                           freq, steps))


def test_rans_aligned_kernel_on_odd_refill_addresses(dev):
    """Refills that start one byte into their buffer take the byte-load
    instance; the result is the same."""
    from jsplayer_tpu_torch.kernels.rans_lanes import (
        rans_decode_aligned, rans_decode_aligned_ref)

    refills, _, states, freq = rans_inputs(2, 96, 21, 1, 7)
    buf = torch.zeros(refills.numel() + 1, dtype=torch.uint8, device=dev)
    odd = torch.as_strided(buf, refills.shape, refills.stride(), 1)
    odd.copy_(refills.to(dev))
    assert odd.data_ptr() % 2 == 1
    got = rans_decode_aligned(odd, states.to(dev), freq.to(dev))
    assert torch.equal(got.cpu(), rans_decode_aligned_ref(refills, states,
                                                          freq))


@pytest.mark.parametrize("case", sorted(RANS_CASES))
def test_rans_kernel_cases(dev, case):
    """Both decodes on each of RANS_CASES against their twins, bit for bit,
    the inputs on the card at the case's offsets and strides; the aligned
    decode ran the case's instance."""
    from jsplayer_tpu_torch.kernels.rans_lanes import (
        rans_decode_aligned, rans_decode_aligned_ref, rans_decode_packed,
        rans_decode_packed_ref)

    _, _, steps, _, rf_off, ln_off, pad, instance = RANS_CASES[case]
    refills, lanes, states, freq = rans_case_inputs(case)
    rf = offset_view(refills, rf_off, device=dev)
    ln = offset_view(lanes, ln_off, pad, device=dev)
    st, fq = states.to(dev), freq.to(dev)
    before = rans_decode_aligned.by_instance[instance]
    got_a = rans_decode_aligned(rf, st, fq)
    got_p = rans_decode_packed(ln, st, fq, steps)
    torch.cuda.synchronize()
    assert rans_decode_aligned.last_instance == instance
    assert rans_decode_aligned.by_instance[instance] == before + 1
    assert torch.equal(got_a.cpu(), rans_decode_aligned_ref(refills, states,
                                                            freq))
    assert torch.equal(got_p.cpu(), rans_decode_packed_ref(lanes, states,
                                                           freq, steps))


@pytest.mark.parametrize("B,N,steps", [(1, 1, 5), (2, 130, 77), (4, 4096, 40)])
def test_rans_chain_probe(dev, B, N, steps):
    """The chain probe (experiments/lane_step.chain_probe) against its twin
    on random u32 states and the grid's tables."""
    from jsplayer_tpu_torch.experiments.lane_step import (chain_probe,
                                                          chain_probe_ref)

    _, _, states, freq = rans_inputs(B, N, 1, 0, B * N + steps)
    got = chain_probe(states.to(dev), freq.to(dev), steps)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), chain_probe_ref(states, freq, steps))


@pytest.mark.parametrize("n_lanes", [1, 8, 64, 128])
@pytest.mark.parametrize("dist", ["uniform", "skewed", "peaked"])
def test_rans_kernels_on_the_grid(dev, n_lanes, dist):
    """The round-trip helpers on the card recover the symbols on the grid
    of tests/test_rans_lanes.py, as the twins do."""
    from jsplayer_tpu_torch.kernels import rans_lanes as R
    from test_torch_rans_cases import seed_of, symbols

    syms = symbols(dist, 3000, seed_of("cuda", n_lanes, dist))
    freq = R.build_freq_table(syms)
    lane_bytes, states, ns = R.encode_lanes(syms, freq, n_lanes)
    for fn in (R.roundtrip_decode, R.roundtrip_decode_aligned):
        np.testing.assert_array_equal(
            fn(lane_bytes, states, freq, ns, n_lanes, device=dev), syms)


def lane_containers(payload, n=3):
    from jsplayer_tpu_torch.transcode import transcode_to_lane

    return [transcode_to_lane(stills_avi(s, nframes=14), window=5, K=2,
                              payload=payload) for s in (3, 7, 11)[:n]]


@pytest.mark.parametrize("payload", ["raw", "rans"])
@pytest.mark.parametrize("kw", [
    dict(), dict(still_elision=True, model_downscale=2),
    dict(emit_frames=False, model_downscale=2)])
def test_lane_ingest_cuda_matches_cpu(dev, payload, kw):
    """The lane path on the card against the same pipeline on the CPU (the
    plain twins): dense, elided with model tensors, model-only."""
    from jsplayer_tpu_torch.core.source import MemorySource
    from jsplayer_tpu_torch.kernels.lane_recon import lane_compose
    from jsplayer_tpu_torch.pipeline import ingest as P

    conts = lane_containers(payload)
    outs = {}
    for d in ("cpu", "cuda"):
        before = lane_compose.launches
        pipe = P.VideoIngestPipeline([MemorySource(c) for c in conts],
                                     P.IngestConfig(device=d, **kw))
        outs[d] = list(pipe)
        assert (lane_compose.launches > before) == (d == "cuda")
    assert len(outs["cpu"]) == len(outs["cuda"]) > 1
    for a, b in zip(outs["cpu"], outs["cuda"]):
        assert a.keys() == b.keys()
        for k, v in a.items():
            if isinstance(v, torch.Tensor):
                assert torch.equal(v, b[k].cpu()), k
            else:
                np.testing.assert_array_equal(np.asarray(v), np.asarray(b[k]))


# -- kmv_sparse (csrc/kmv_sparse.cu) and MSV1 paint (csrc/msv1_paint.cu) -----

@pytest.mark.parametrize("case", sorted(SPARSE_CASES))
def test_sparse_kernel_cases(dev, case):
    """csrc/kmv_sparse.cu against its plain twin, bit for bit, on the
    shapes, layouts, starts, indices and vectors that pick each path of the
    kernel (tests/test_torch_sparse_cases.py SPARSE_CASES): overlapping
    clamped edge tiles (the owner list and its overflow walk), duplicated,
    off-grid and wild starts, indices that wrap or fall outside the tile
    rows, wrapping vectors and -2^31, codes 1 and past 2+K, M = 1 and
    M = NB, Y and X not multiples of 16, offset, odd-stride and window
    views, unaligned and wide tile rows, K = 0 and 8, unchanged streams
    with garbage commands."""
    from jsplayer_tpu_torch.kernels.sp_recon import kmv_sparse_compose_ref

    prev, args, chg, got = run_sparse_case(case, dev)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, kmv_sparse_compose_ref(prev, *args, chg),
                               rtol=0, atol=0)


@pytest.mark.parametrize("seq", sorted(SPARSE_SEQUENCES))
def test_sparse_kernel_sequences(dev, seq):
    """SPARSE_SEQUENCES' steps one after another on the card, each against
    its twin: the cell scratch the calls share must be clean at every call
    (fewer tiles after more, M = 0 after tiles, a stream unchanged after it
    had tiles and changed again)."""
    from jsplayer_tpu_torch.kernels.sp_recon import kmv_sparse_compose_ref

    for case in SPARSE_SEQUENCES[seq]:
        prev, args, chg, got = run_sparse_case(case, dev)
        torch.cuda.synchronize()
        assert torch.equal(got, kmv_sparse_compose_ref(prev, *args, chg)), \
            case


def sparse_on_card(name, dev):
    """SPARSE_CASES[name] on the card → (prev, args, changed, the twin's out
    on the CPU)."""
    from jsplayer_tpu_torch.kernels.sp_recon import kmv_sparse_compose_ref
    from test_torch_sparse_cases import sparse_case

    prev, args, chg = sparse_case(name)
    want = kmv_sparse_compose_ref(prev, *args, chg)
    return prev.to(dev), [a.to(dev) for a in args], chg.to(dev), want


def test_sparse_kernel_graph_replay(dev):
    """Two steps of different layouts (more tiles, then fewer) captured in
    one CUDA graph and replayed three times, an eager call between the
    replays: every out against its twin.  The first capture starts without
    a kept scratch on its stream (its fill becomes a node of the graph),
    the second with one (eager calls on the capture's stream first)."""
    from jsplayer_tpu_torch.kernels import sp_recon as P

    steps = [(pv, a, c, torch.full_like(pv, -7), want) for pv, a, c, want
             in (sparse_on_card(n, dev)
                 for n in SPARSE_SEQUENCES["fewer_tiles"])]

    def calls():
        for pv, a, c, out, _ in steps:
            P.kmv_sparse_compose(pv, *a, c, out=out)

    def check():
        torch.cuda.synchronize()
        for *_, out, want in steps:
            assert torch.equal(out.cpu(), want)

    s = torch.cuda.Stream(dev)
    s.wait_stream(torch.cuda.current_stream(dev))
    key = (dev, s.cuda_stream)
    for kept in (False, True):
        P._CELLS.pop(key, None)
        with torch.cuda.stream(s):
            if kept:
                calls()
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=s):
                calls()
            assert (key in P._CELLS) == kept
            for _ in range(3):
                for *_, out, _ in steps:
                    out.fill_(-7)
                graph.replay()
                check()
                calls()
                check()


def test_sparse_graph_replay_after_the_scratch_grew(dev):
    """Port fault P1: a graph captured with its stream's kept scratch, then
    an eager call on that stream at a larger B*NB (the scratch grows), then
    canaries of the old scratch's size on that stream (where the caching
    allocator would place them, were the old scratch freed), then the
    replay: its out equals the twin and every canary is unchanged."""
    from jsplayer_tpu_torch.kernels import sp_recon as P

    (pv, a, c, want), (pv2, a2, c2, want2) = (
        sparse_on_card(n, dev) for n in ("seq_many", "edge_tiles_1080"))
    s = torch.cuda.Stream(dev)
    s.wait_stream(torch.cuda.current_stream(dev))
    key = (dev, s.cuda_stream)
    P._CELLS.pop(key, None)
    with torch.cuda.stream(s):
        out = torch.full_like(pv, -7)
        P.kmv_sparse_compose(pv, *a, c, out=out)
        # no reference to the scratch here: only the wrapper's may keep it
        held, cells = P._CELLS[key][-1].data_ptr(), P._CELLS[key][-1].shape
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=s):
            P.kmv_sparse_compose(pv, *a, c, out=out)
        got2 = P.kmv_sparse_compose(pv2, *a2, c2)
        canaries = [torch.full(cells, 0x5A5A5A5A, dtype=torch.int32,
                               device=dev) for _ in range(8)]
        assert [t.data_ptr() for t in P._CELLS[key]][:1] == [held]
        assert len(P._CELLS[key]) == 2
        out.fill_(-7)
        graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), want)
    assert torch.equal(got2.cpu(), want2)
    assert all(bool((t == 0x5A5A5A5A).all()) for t in canaries)


def test_sparse_streams_get_their_own_scratch(dev):
    """Two streams composing at once, each a case of its own, interleaved
    launch by launch: each stream has its own scratch and every out equals
    its twin."""
    from jsplayer_tpu_torch.kernels import sp_recon as P

    streams = [torch.cuda.Stream(dev) for _ in range(2)]
    cases = [sparse_on_card(n, dev) for n in ("seq_many", "host_layout")]
    outs = [[torch.full_like(pv, -7) for _ in range(16)]
            for pv, *_ in cases]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream(dev))
    for i in range(16):
        for s, (pv, a, c, _), o in zip(streams, cases, outs):
            with torch.cuda.stream(s):
                P.kmv_sparse_compose(pv, *a, c, out=o[i])
    torch.cuda.synchronize()
    held = [P._CELLS[(dev, s.cuda_stream)][-1] for s in streams]
    assert held[0].data_ptr() != held[1].data_ptr()
    for (*_, want), o in zip(cases, outs):
        assert all(torch.equal(t.cpu(), want) for t in o)


def test_sparse_call_after_a_failed_launch(dev, monkeypatch):
    """A launch that fails after setting headers (forced: a stand-in for
    the C entry that dirties the scratch and returns an error) raises; the
    next call refills the same scratch in place and equals its twin."""
    from jsplayer_tpu_torch import _build
    from jsplayer_tpu_torch.kernels import sp_recon as P

    pv, a, c, want = sparse_on_card("seq_many", dev)
    P.kmv_sparse_compose(pv, *a, c)
    key = (dev, torch.cuda.current_stream(dev).cuda_stream)
    scratch = P._CELLS[key][-1]
    lib = _build.load()

    class Failing:
        def __getattr__(self, name):
            return getattr(lib, name)

        @staticmethod
        def jsp_kmv_sparse_compose(*_):
            scratch.fill_(3)  # headers set, none put back
            return 1  # cudaErrorInvalidValue

    monkeypatch.setattr(_build, "load", Failing)
    with pytest.raises(RuntimeError, match="launch failed"):
        P.kmv_sparse_compose(pv, *a, c)
    assert key in P._REFILL
    monkeypatch.undo()
    got = P.kmv_sparse_compose(pv, *a, c)
    assert P._CELLS[key][-1] is scratch and key not in P._REFILL
    assert torch.equal(got.cpu(), want)


def test_sparse_kernel_rejects_aliased_out_and_wrong_types(dev):
    from jsplayer_tpu_torch.kernels.sp_recon import kmv_sparse_compose

    prev = torch.zeros((2, 16, 16), dtype=torch.int32, device=dev)
    bcode = torch.zeros((2, 1), dtype=torch.uint8, device=dev)
    mvk = torch.zeros((2, 2, 2), dtype=torch.int32, device=dev)
    tiles = torch.zeros((3, 256), dtype=torch.int32, device=dev)
    idx = torch.zeros((2, 4), dtype=torch.int32, device=dev)
    yx = torch.zeros((2, 4, 2), dtype=torch.int32, device=dev)
    chg = torch.ones(2, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="alias"):
        kmv_sparse_compose(prev, bcode, mvk, tiles, idx, yx, chg, out=prev)
    with pytest.raises(TypeError, match="uint8"):
        kmv_sparse_compose(prev, bcode.int(), mvk, tiles, idx, yx, chg)
    with pytest.raises(ValueError, match="tile_yx"):
        kmv_sparse_compose(prev, bcode, mvk, tiles, idx, yx[:, :2], chg)
    with pytest.raises(ValueError, match="tiles"):
        kmv_sparse_compose(prev, bcode, mvk, tiles[:, :128], idx, yx, chg)
    with pytest.raises(IndexError):
        kmv_sparse_compose(prev, bcode, mvk, tiles[:0], idx, yx, chg)


@pytest.mark.parametrize("B,T,Y,X,M", [(1, 3, 1080, 1920, 64),
                                       (4, 2, 1080, 1920, 8160),
                                       (3, 4, 40, 56, 12)])
def test_sparse_scan_on_the_card(dev, B, T, Y, X, M):
    """decode_batch_kmv_sparse (dense tiles, an identity index) and the
    ragged scan over the same tiles, on the card, against the plain scan:
    host-layout starts (clamped edges, M = NB at 1080p: every block a
    tile, as a mid-window keyframe ships)."""
    from jsplayer_tpu_torch.kernels import sp_recon as P

    rng = np.random.default_rng(B * T + M)
    nby, nbx = (Y + 15) // 16, (X + 15) // 16
    nb = nby * nbx
    blocks = np.sort(rng.random((B, T, nb)).argsort(-1)[..., :M], -1) \
        if M < nb else np.broadcast_to(np.arange(nb), (B, T, nb))
    by, bx = np.divmod(blocks, nbx)
    yx = np.stack([np.minimum(by * 16, Y - 16), np.minimum(bx * 16, X - 16)],
                  -1).astype(np.int32)
    init = rand_u32((B, Y, X), 1)
    bcode = torch.from_numpy(rng.integers(0, 5, (B, T, nb)).astype(np.uint8))
    mvk = torch.from_numpy(rng.integers(-40, 40, (B, T, 2, 2))
                           .astype(np.int32))
    tiles = rand_u32((B, T, M, 16, 16), 2)
    chg = torch.from_numpy(rng.random((B, T)) < 0.8)
    args = (init, bcode, mvk, tiles, torch.from_numpy(yx), chg)
    want = P.decode_batch_kmv_sparse(*args)
    before = P.kmv_sparse_compose.launches
    got = P.decode_batch_kmv_sparse(*(a.to(dev) for a in args))
    torch.cuda.synchronize()
    assert P.kmv_sparse_compose.launches == before + T
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("case", sorted(MSV1_CASES))
def test_msv1_kernel_cases(dev, case):
    """csrc/msv1_paint.cu against its plain twin, bit for bit, frames and
    diff flags, on tests/test_torch_msv1_cases.py MSV1_CASES: offset views
    (the scalar instance), window slices, rows past 128 columns and short
    of them, warps of 8 blocks part out of the frame, windows around the
    ring's depth and the diff mask's flush, insignificant lines, every
    block painted or none, sel >= 8; each through the instance its views
    pick."""
    from jsplayer_tpu_torch.kernels.msv1_paint import (msv1_paint,
                                                       msv1_paint_ref)

    args, frames, diff = run_msv1_case(case, dev)
    torch.cuda.synchronize()
    assert msv1_paint.last_instance == (
        "staged" if vector_path(case) else "scalar")
    want_f, want_d = msv1_paint_ref(*args[:4], args[6])
    torch.testing.assert_close(frames, want_f, rtol=0, atol=0)
    assert torch.equal(diff, want_d)


def test_msv1_window_at_cif_on_the_card(dev):
    """decode_batch at CIF, B=8 x 32 steps: frames and significance against
    the plain decode."""
    from jsplayer_tpu_torch.kernels import msv1_paint as M

    B, T, Y, X = 8, 32, 288, 352
    rng = np.random.default_rng(5)
    nb = (Y // 4) * (X // 4)
    init = rand_u32((B, Y, X), 3)
    bt = torch.from_numpy(((rng.random((B, T, nb)) < 0.1)
                           * rng.integers(1, 3, (B, T, nb))).astype(np.uint8))
    sel = torch.from_numpy(rng.integers(0, 9, (B, T, Y, X)).astype(np.uint8))
    col = rand_u32((B, T, nb, 8), 4)
    chg = torch.from_numpy(rng.random((B, T)) < 0.9)
    valid = torch.from_numpy(rng.random(B) < 0.5)
    args = (init, valid, bt, sel, col, chg, 3, 9, X // 4)
    want = M.decode_batch(*args)
    got = M.decode_batch(*(a.to(dev) if isinstance(a, torch.Tensor) else a
                           for a in args))
    torch.cuda.synchronize()
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


def ingest_on_both(avis, **kw):
    """The pipeline on the CPU and on the card → (cpu windows, cuda
    windows), keys and values checked equal."""
    from jsplayer_tpu_torch.core.source import MemorySource
    from jsplayer_tpu_torch.pipeline import ingest as P

    outs = {}
    for d in ("cpu", "cuda"):
        pipe = P.VideoIngestPipeline([MemorySource(a) for a in avis],
                                     P.IngestConfig(device=d, **kw))
        outs[d] = list(pipe)
    assert len(outs["cpu"]) == len(outs["cuda"]) > 1
    for a, b in zip(outs["cpu"], outs["cuda"]):
        assert a.keys() == b.keys()
        for k, v in a.items():
            if isinstance(v, torch.Tensor):
                assert torch.equal(v, b[k].cpu()), k
            else:
                np.testing.assert_array_equal(np.asarray(v), np.asarray(b[k]))
    return outs


@pytest.mark.parametrize("kw", [
    dict(window=4), dict(window=5, model_downscale=2),
    dict(window=4, sparse_lane_payload=True, model_downscale=2)])
def test_sparse_ingest_cuda_matches_cpu(dev, kw):
    """kmv_sparse on the card against the same pipeline on the CPU: mid-GOP
    and keyframe-led windows, raw and rANS-coded tiles (the packed decode
    launches)."""
    from jsplayer_tpu_torch.kernels.rans_lanes import rans_decode_packed
    from jsplayer_tpu_torch.kernels.sp_recon import kmv_sparse_compose

    before = (kmv_sparse_compose.launches, rans_decode_packed.launches)
    ingest_on_both([stills_avi(s, nframes=14) for s in (3, 7, 11)],
                   sp_device_path="kmv_sparse", **kw)
    assert kmv_sparse_compose.launches > before[0]
    assert (rans_decode_packed.launches > before[1]) == \
        kw.get("sparse_lane_payload", False)


def test_msv1_ingest_cuda_matches_cpu(dev):
    """MSV1 16-bit windows on the card against the CPU, one msv1_paint
    launch a window."""
    from jsplayer_tpu_torch.encode.avi_mux import mux_avi
    from jsplayer_tpu_torch.encode.msv1_enc import encode_frame_16
    from jsplayer_tpu_torch.kernels.msv1_paint import msv1_paint

    avis = []
    for s in range(3):
        rng = np.random.default_rng(s)
        f = np.full(32 * 48, 0x080808, dtype=np.uint32)
        chunks, prev = [], None
        for t in range(11):
            f = f.copy()
            x0 = int(rng.integers(0, 11)) * 4
            f.reshape(32, 48)[8:12, x0:x0 + 4] = 0x080808 * int(
                rng.integers(1, 31))
            chunks.append(encode_frame_16(f, prev, 48, 32))
            prev = f
        avis.append(mux_avi(chunks, 48, 32, 16, codec="CRAM",
                            keyflags=[t == 0 for t in range(11)]))
    before = msv1_paint.launches
    outs = ingest_on_both(avis, window=4, model_downscale=2)
    assert msv1_paint.launches == before + len(outs["cuda"])


@pytest.mark.parametrize("dp,gop", [(2, 1), (2, 2)])
def test_mesh_kmv_step_on_card_slots(dev, dp, gop):
    """The sharded kmv step on a mesh of cuda:0 slots (one card holds
    every slot) equals the unsharded decode_batch_kmv of the same rows,
    bit for bit, with one kmv_compose launch a scan step a slot."""
    from jsplayer_tpu_torch.kernels.sp_recon import decode_batch_kmv, \
        kmv_compose
    from jsplayer_tpu_torch.pipeline.batch import DecodeConfig, \
        make_sp_decode_step_kmv
    from jsplayer_tpu_torch.pipeline.mesh import make_mesh

    B, G, T, Y, X, K = 4, 2, 5, 72, 136, 2
    rng = np.random.default_rng(dp * 10 + gop)
    init = rng.integers(0, 1 << 32, (B, G, Y, X), dtype=np.uint64) \
        .astype(np.uint32)
    pc = (rng.integers(0, 1 << 24, (B, G, T, Y, X), dtype=np.uint32)
          | (rng.integers(0, 4, (B, G, T, Y, X), dtype=np.uint32) << 24)
          | (rng.integers(0, 4, (B, G, T, Y, X), dtype=np.uint32) << 26))
    mvk = rng.integers(-200, 200, (B, G, T, K, 2)).astype(np.int32)
    chg = rng.integers(0, 4, (B, G, T)) > 0
    mesh = make_mesh(dp=dp, gop=gop, devices=[dev] * (dp * gop))
    before = kmv_compose.launches
    got = make_sp_decode_step_kmv(mesh, DecodeConfig(height=Y, width=X))(
        init, pc, mvk, chg)
    torch.cuda.synchronize()
    assert kmv_compose.launches == before + dp * gop * T
    assert got.device == dev and tuple(got.shape) == (B, G, T, Y, X)

    def flat(a):  # [B, G, ...] → the [B*G, ...] batch on the card
        a = np.ascontiguousarray(a).reshape((B * G,) + a.shape[2:])
        return torch.from_numpy(
            a.view(np.int32) if a.dtype == np.uint32 else a).to(dev)

    want = decode_batch_kmv(flat(init), flat(pc), flat(mvk), flat(chg))
    assert torch.equal(got.reshape((B * G,) + got.shape[2:]), want)


@pytest.mark.parametrize("shape,patch", [((3, 32, 64), 8), ((2, 48, 80), 16)])
def test_packed_consumer_step_on_the_card(dev, shape, patch):
    """packed_consumer_step on the card: bit-exact against the same patch
    embed over to_model_input(downscale=2) on the card, within 2 bf16 ulps
    (the CPU test's tolerance) of its CPU twin."""
    from jsplayer_tpu_torch.kernels.rgb_convert import (ds2_packed_output,
                                                        packed_consumer_step,
                                                        patch_embed,
                                                        to_model_input)

    C, Y2, X2 = shape
    f = (rand_u32((C, 2 * Y2, 2 * X2), seed=patch) & 0xFFFFFF).to(dev)
    rng = np.random.default_rng(C)
    w = torch.from_numpy(rng.normal(0, 0.05, (patch, patch, 3, 16)).astype(
        np.float32)).to(dev, torch.bfloat16)
    red = ds2_packed_output(f)
    got = packed_consumer_step(red, w)
    assert torch.equal(got, patch_embed(to_model_input(f, downscale=2), w))
    cpu = packed_consumer_step(red.cpu(), w.cpu())
    torch.testing.assert_close(got.cpu().float(), cpu.float(),
                               rtol=2 ** -7, atol=1e-3)


def test_render_on_the_card_matches_the_cpu(dev, tmp_path, capsys):
    """`render --device cuda` writes the files `--device cpu` writes, an SP
    stream through kmv_compose and an MSV1 one through msv1_paint."""
    import os

    from jsplayer_tpu_torch.__main__ import main
    from jsplayer_tpu_torch.codecs.msvideo1 import from_rgb15
    from jsplayer_tpu_torch.encode.avi_mux import mux_avi
    from jsplayer_tpu_torch.encode.msv1_enc import encode_frame_16
    from jsplayer_tpu_torch.encode.sp_enc import ScreenPressorEncoder
    from jsplayer_tpu_torch.kernels.msv1_paint import msv1_paint
    from jsplayer_tpu_torch.kernels.sp_recon import kmv_compose

    rng = np.random.default_rng(3)
    enc, sp, ms, prev = ScreenPressorEncoder(4, 32, 32), [], [], None
    f = np.full((32, 32), 0x102030, dtype=np.uint32)
    for t in range(6):
        f = f.copy()
        f[4 * t:4 * t + 4, 2:30] = rng.integers(0, 1 << 24)
        sp.append(enc.encode_i(f.reshape(-1)) if t == 0
                  else enc.encode_p(f.reshape(-1)))
        m = np.full(32 * 32, from_rgb15(0x0421), dtype=np.uint32)
        m[: 32 * (t + 1)] = from_rgb15(int(rng.integers(0, 0x8000)))
        ms.append(encode_frame_16(m, prev, 32, 32))
        prev = m
    keys = [t == 0 for t in range(6)]
    for name, data, counter in (
            ("sp", mux_avi(sp, 32, 32, 24, codec="SPV4", keyflags=keys),
             kmv_compose),
            ("msv1", mux_avi(ms, 32, 32, 16, codec="CRAM", keyflags=keys),
             msv1_paint)):
        src = tmp_path / f"{name}.avi"
        src.write_bytes(data)
        dirs = {d: str(tmp_path / f"{name}_{d}") for d in ("cpu", "cuda")}
        before = counter.launches
        for d, out in dirs.items():
            assert main(["render", str(src), out, "--window", "4",
                         "--device", d]) == 0
        capsys.readouterr()
        assert counter.launches > before
        names = sorted(os.listdir(dirs["cpu"]))
        assert names == sorted(os.listdir(dirs["cuda"])) and len(names) == 6
        for n in names:
            with open(os.path.join(dirs["cpu"], n), "rb") as a, \
                    open(os.path.join(dirs["cuda"], n), "rb") as b:
                assert a.read() == b.read(), (name, n)


# -- sparse_payload: csrc/sparse_payload.cu -----------------------------------

def payload_on_card(tiles, tb, dev):
    return (torch.from_numpy(np.ascontiguousarray(tiles).view(np.int32))
            .to(dev), torch.from_numpy(np.ascontiguousarray(tb)).to(dev))


@pytest.mark.parametrize("case", sorted(PAYLOAD_CASES))
def test_unpack_payload_kernel_cases(dev, case):
    """The scatter against the one-hot product's twin, bit for bit, on
    every edge of PAYLOAD_CASES (one launch a call)."""
    from jsplayer_tpu_torch.kernels.sparse_payload import (
        unpack_payload, unpack_payload_ref)
    from test_torch_payload_cases import NB, X, Y, case_inputs

    tiles, tb = case_inputs(case)
    ct, cb = payload_on_card(tiles, tb, dev)
    before = unpack_payload.launches
    got = unpack_payload(ct, cb, NB, Y, X)
    want = unpack_payload_ref(ct, cb, NB, Y, X)
    torch.cuda.synchronize()
    assert unpack_payload.launches == before + 1
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), unpack_payload_ref(
        ct.cpu(), cb.cpu(), NB, Y, X))


@pytest.mark.parametrize("T,M,Y,X", [(1, 8, 32, 64), (4, 40, 96, 160),
                                     (3, 700, 1440, 2560)])
@pytest.mark.parametrize("layout", ["contiguous", "every_other",
                                    "padded_rows", "unaligned_rows"])
def test_unpack_payload_kernel_windows(dev, T, M, Y, X, layout):
    """A window in one launch, frame by frame equal to the twin: tiles
    contiguous, every other tile of a [T, 2M, 256] stack, 256-word rows of
    [T, M, 260] (16-byte path) and of [T, M, 257] (4-byte path)."""
    from jsplayer_tpu_torch.kernels.sparse_payload import (
        unpack_payload, unpack_payload_ref)
    from test_torch_payload_cases import window_inputs

    nb = (Y // 16) * (X // 16)
    tiles, tb = window_inputs(T, 2 * M, seed=T + M, nb=nb)
    ct, cb = payload_on_card(tiles, tb, dev)
    if layout == "every_other":
        ct, cb = ct[:, ::2], cb[:, ::2].contiguous()
    else:
        ct, cb = ct[:, :M], cb[:, :M].contiguous()
        if layout != "contiguous":
            w = 260 if layout == "padded_rows" else 257
            buf = torch.zeros((T, M, w), dtype=torch.int32, device=dev)
            buf[..., w - 256:] = ct
            ct = buf[..., w - 256:]
    before = unpack_payload.launches
    got = unpack_payload(ct, cb, nb, Y, X)
    torch.cuda.synchronize()
    assert unpack_payload.launches == before + 1
    for t in range(T):
        assert torch.equal(got[t], unpack_payload_ref(ct[t], cb[t], nb, Y,
                                                      X)), t


def test_decode_sequence_sparse_on_the_card(dev):
    """The sparse decode on the card: one unpack_payload launch, one
    sp_compose_general launch a step, frames and flags equal to the CPU
    run's."""
    from jsplayer_tpu_torch.encode.sp_enc import ScreenPressorEncoder
    from jsplayer_tpu_torch.kernels import sp_recon
    from jsplayer_tpu_torch.kernels.sparse_payload import (
        decode_sequence_sparse, pack_sequence, unpack_payload)
    from jsplayer_tpu_torch.pipeline.batch import stack_sp_commands

    Y, X = 64, 128
    enc = ScreenPressorEncoder(4, X, Y)
    rng = np.random.default_rng(4)
    f = rng.integers(0, 1 << 24, (Y, X)).astype(np.uint32)
    chunks = [enc.encode_i(f.reshape(-1))]
    for t in range(6):
        f = f.copy()
        f[3 * t:3 * t + 9, 5:70] = rng.integers(0, 1 << 24)
        f[20:, :] = np.roll(f[20:, :], 3, axis=0) if t % 2 else f[20:, :]
        chunks.append(enc.encode_p(f.reshape(-1)))
    cmds = stack_sp_commands([chunks], X, Y)
    bts = cmds["bts"][0, 0]
    m_max = int(((bts > 0) & (bts != 3)).sum(axis=1).max())
    tiles, blocks = pack_sequence(cmds["payload"][0, 0], bts, m_max)
    host = [torch.from_numpy(np.ascontiguousarray(a).view(np.int32)
                             if a.dtype == np.uint32 else a)
            for a in (bts, cmds["mv"][0, 0], cmds["rect"][0, 0], tiles,
                      blocks)]
    chg = torch.from_numpy(cmds["changed"][0, 0])
    init = torch.zeros((Y, X), dtype=torch.int32)
    want = decode_sequence_sparse(init, *host, chg, 2)
    launches = unpack_payload.launches, sp_recon.sp_compose_general.launches
    got = decode_sequence_sparse(init.to(dev), *(a.to(dev) for a in host),
                                 chg.to(dev), 2)
    torch.cuda.synchronize()
    assert unpack_payload.launches == launches[0] + 1
    assert sp_recon.sp_compose_general.launches == \
        launches[1] + len(chunks)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


# -- kmv_compose_frames: csrc/kmv_compose.cu's frames instance ---------------

def frames_inputs(U, Y, X, K, seed, data=0.3, motion=0.5, mv=None):
    """prev and U kmv frames on the CPU: data, motion and copy pixels; the
    motion vectors move whole rows, so each frame reads rows the frame
    before wrote."""
    rng = np.random.default_rng(seed)
    prev = rand_u32((Y, X), seed=seed + 1)
    r = rng.random((U, Y, X))
    ptype = np.where(r < data, 1, np.where(r < data + motion, 2, 0))
    word = (rng.integers(0, 1 << 24, (U, Y, X), dtype=np.uint32)
            | (ptype.astype(np.uint32) << 24)
            | (rng.integers(0, K + 1, (U, Y, X), dtype=np.uint32) << 26))
    if mv is None:
        mv = rng.integers(-3 * max(X, Y), 3 * max(X, Y), (U, K, 2))
    return (prev, torch.from_numpy(word.view(np.int32)),
            torch.from_numpy(np.asarray(mv, dtype=np.int32)))


@pytest.mark.parametrize("U,Y,X,K", [(1, 16, 16, 1), (2, 48, 80, 2),
                                     (8, 1080, 1920, 2), (3, 33, 71, 8),
                                     (4, 40, 62, 3)])
def test_kmv_compose_frames_kernel(dev, U, Y, X, K):
    """U chained composes in one launch against U single-frame twins; at
    1080p U = 8 with vectors of a row or two, so that frame u reads pixels
    frame u-1 wrote in the same launch (a stale read of them fails)."""
    from jsplayer_tpu_torch.kernels.sp_recon import (kmv_compose_frames,
                                                     kmv_compose_frames_ref)

    mv = [[[0, 1], [-3, -2]]] * U if Y == 1080 else None
    prev, pc, mvk = frames_inputs(U, Y, X, K, seed=U * 13 + Y, mv=mv)
    want = kmv_compose_frames_ref(prev, pc, mvk)
    out = torch.full((U + 1, Y, X), -5, dtype=torch.int32, device=dev)
    before = kmv_compose_frames.launches
    got = kmv_compose_frames(prev.to(dev), pc.to(dev), mvk.to(dev),
                             out=out[1:])
    torch.cuda.synchronize()
    assert kmv_compose_frames.launches == before + 1
    assert kmv_compose_frames.last_grid > 0
    assert torch.equal(got.cpu(), want)
    assert (out[0] == -5).all()


@pytest.mark.parametrize("grid", [1, 3, 37])
def test_kmv_compose_frames_small_grids(dev, grid):
    """A grid of fewer blocks than tiles walks every tile of every frame."""
    from jsplayer_tpu_torch.kernels.sp_recon import (kmv_compose_frames,
                                                     kmv_compose_frames_ref)

    prev, pc, mvk = frames_inputs(4, 96, 256, 2, seed=grid)
    got = kmv_compose_frames(prev.to(dev), pc.to(dev), mvk.to(dev),
                             grid=grid)
    torch.cuda.synchronize()
    assert kmv_compose_frames.last_grid == grid
    assert torch.equal(got.cpu(), kmv_compose_frames_ref(prev, pc, mvk))


def test_kmv_compose_frames_grid_that_cannot_be_resident_raises(dev):
    """One block more than can be co-resident (the default grid of a frame
    with more tiles than that): the cooperative launch is refused and the
    wrapper raises; the next call runs."""
    from jsplayer_tpu_torch.kernels.sp_recon import (kmv_compose_frames,
                                                     kmv_compose_frames_ref)

    prev, pc, mvk = frames_inputs(2, 1080, 1920, 2, seed=9)
    args = prev.to(dev), pc.to(dev), mvk.to(dev)
    kmv_compose_frames(*args)
    most = kmv_compose_frames.last_grid
    assert 0 < most < 15 * 68  # fewer blocks than the frame's tiles
    before = kmv_compose_frames.launches
    with pytest.raises(RuntimeError, match="kmv_compose_frames launch "
                                           "failed"):
        kmv_compose_frames(*args, grid=most + 1)
    assert kmv_compose_frames.launches == before
    got = kmv_compose_frames(*args, grid=most)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), kmv_compose_frames_ref(prev, pc, mvk))


def test_kmv_compose_frames_rejects_overlaps(dev):
    from jsplayer_tpu_torch.kernels.sp_recon import kmv_compose_frames

    buf = torch.zeros((3, 16, 16), dtype=torch.int32, device=dev)
    mvk = torch.zeros((2, 1, 2), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="overlap prev"):
        kmv_compose_frames(buf[0], buf[1:], mvk, out=buf[:2])
    with pytest.raises(ValueError, match="overlap paycode"):
        kmv_compose_frames(buf[0], buf[1:], mvk, out=buf[1:])


@pytest.mark.parametrize("unroll", [1, 2, 4, 8])
def test_unrolled_scan_on_the_card(dev, unroll):
    """decode_sequence_kmv_compact_unrolled: T / U launches, bit-equal to
    decode_sequence_kmv_compact on the card and to the CPU twin."""
    from jsplayer_tpu_torch.kernels.sp_recon import (
        decode_sequence_kmv_compact, decode_sequence_kmv_compact_unrolled,
        kmv_compose_frames)

    T = 16
    prev, pc, mvk = frames_inputs(T, 72, 136, 2, seed=unroll)
    pc[5] = 0  # an all-copy plane mid-stream
    args = prev.to(dev), pc.to(dev), mvk.to(dev)
    before = kmv_compose_frames.launches
    got = decode_sequence_kmv_compact_unrolled(*args, unroll=unroll)
    torch.cuda.synchronize()
    assert kmv_compose_frames.launches == before + T // unroll
    assert torch.equal(got, decode_sequence_kmv_compact(*args))
    assert torch.equal(got.cpu(), decode_sequence_kmv_compact_unrolled(
        prev, pc, mvk, unroll=unroll))


def test_kmv_compose_frames_graph_replay(dev):
    """The cooperative launch captured in a CUDA graph and replayed, an
    eager call between the replays, equal to the twin each time."""
    from jsplayer_tpu_torch.kernels.sp_recon import (kmv_compose_frames,
                                                     kmv_compose_frames_ref)

    prev, pc, mvk = frames_inputs(4, 120, 256, 2, seed=11)
    want = kmv_compose_frames_ref(prev, pc, mvk)
    args = prev.to(dev), pc.to(dev), mvk.to(dev)
    out = torch.empty((4, 120, 256), dtype=torch.int32, device=dev)
    s = torch.cuda.Stream(dev)
    s.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(s):
        kmv_compose_frames(*args, out=out)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=s):
            kmv_compose_frames(*args, out=out)
        for _ in range(2):
            out.fill_(-1)
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out.cpu(), want)
            out.fill_(-1)
            kmv_compose_frames(*args, out=out)
            torch.cuda.synchronize()
            assert torch.equal(out.cpu(), want)


def test_paint_frame_on_the_card(dev):
    """msv1_paint.paint_frame (a one-step msv1_paint launch) against
    paint_frame_ref on a random CIF step."""
    from jsplayer_tpu_torch.kernels.msv1_paint import (msv1_paint,
                                                       paint_frame,
                                                       paint_frame_ref)

    Y, X = 288, 352
    rng = np.random.default_rng(2)
    nb = (Y // 4) * (X // 4)
    prev = rand_u32((Y, X), seed=3)
    bt = torch.from_numpy(rng.integers(0, 3, nb).astype(np.uint8))
    sel = torch.from_numpy(rng.integers(0, 10, (Y, X)).astype(np.uint8))
    col = rand_u32((nb, 8), seed=4)
    before = msv1_paint.launches
    got = paint_frame(prev.to(dev), bt.to(dev), sel.to(dev), col.to(dev))
    torch.cuda.synchronize()
    assert msv1_paint.launches == before + 1
    assert torch.equal(got.cpu(), paint_frame_ref(prev, bt, sel, col))

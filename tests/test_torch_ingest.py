"""The port's ingest pipeline (device="cpu", plain twins) against
jsplayer_tpu's on the same AVI fixtures: every key of every window dict,
bit for bit, plus the elision-layout stats and the quarantine set.  The
fixtures are the makers of tests/test_ingest.py."""

import json

import numpy as np
import pytest
import torch

from jsplayer_tpu.core.source import MemorySource
from jsplayer_tpu.encode.avi_mux import mux_avi
from jsplayer_tpu.encode.sp_enc import ScreenPressorEncoder
from jsplayer_tpu.pipeline import ingest as J
from jsplayer_tpu_torch.pipeline import ingest as P
from test_ingest import msv1_avi, sp_avi, sp_avi_stills

torch.set_num_threads(1)


def bits(v):
    """A window-dict value of either package → comparable numpy bits."""
    if isinstance(v, torch.Tensor):
        return (v.view(torch.int16) if v.dtype == torch.bfloat16 else v).numpy()
    a = np.asarray(v)
    if a.dtype.name == "bfloat16":
        return a.view(np.int16)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def assert_windows_equal(ref, port):
    assert len(ref) == len(port)
    for w, (a, b) in enumerate(zip(ref, port)):
        assert a.keys() == b.keys(), (w, sorted(a), sorted(b))
        for k in a:
            if k == "start_frame":
                assert a[k] == b[k], (w, a[k], b[k])
                continue
            va, vb = bits(a[k]), bits(b[k])
            assert va.shape == vb.shape, (w, k, va.shape, vb.shape)
            np.testing.assert_array_equal(vb, va, err_msg=f"window {w} {k}")


def pipelines(avis, **kw):
    return (J.VideoIngestPipeline([MemorySource(a) for a in avis],
                                  J.IngestConfig(**kw)),
            P.VideoIngestPipeline([MemorySource(a) for a in avis],
                                  P.IngestConfig(device="cpu", **kw)))


def no_native(monkeypatch):
    """Both packages' host stages take the pure-Python oracle branch (the
    port has its own native library)."""
    from jsplayer_tpu import native as j_native
    from jsplayer_tpu_torch import native as p_native

    for mod in (j_native, p_native):
        monkeypatch.setattr(mod, "available", lambda: False)


def compare(avis, **kw):
    jp, pp = pipelines(avis, **kw)
    assert_windows_equal(list(jp), list(pp))
    assert pp.stats == jp.stats
    assert pp.quarantined == jp.quarantined
    return pp


SP3 = [sp_avi(s)[0] for s in (1, 2, 3)]
STILLS3 = [sp_avi_stills(s)[0] for s in (3, 7, 11)]
ALIGNED2 = [sp_avi(s, nframes=20)[0] for s in (31, 32)]


def single_key_stream(nf=20):
    """One keyframe then P-frames with stills: windows after the first
    start mid-GOP (test_ingest_keyframe_aligned_windows' control)."""
    from jsplayer_tpu.encode.sp_enc import pack_rgb

    rng = np.random.default_rng(0)
    enc = ScreenPressorEncoder(4, 32, 32)
    streams = []
    f = np.full((32, 32), pack_rgb(9, 9, 9), dtype=np.uint32)
    for t in range(nf):
        if t % 3 != 2:
            f = f.copy()
            f[(t % 6) * 4:(t % 6) * 4 + 4, 4:20] = pack_rgb(
                *rng.integers(0, 256, 3))
        flat = f.reshape(-1)
        streams.append(enc.encode_i(flat) if t == 0 else enc.encode_p(flat))
    return mux_avi(streams, 32, 32, 24, codec="SPV4",
                   keyflags=[t == 0 for t in range(nf)])


@pytest.mark.parametrize("kw", [
    dict(window=4),                                       # default kmv
    dict(window=4, model_downscale=2),
    dict(window=4, emit_frames=False, model_downscale=2),
    dict(window=4, emit_frames=False),
    dict(window=4, model_downscale=2, model_packed=True),
    dict(window=4, emit_model_input=False),
    dict(window=3, streaming=True),
], ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_dense_windows(kw):
    compare(SP3, **kw)


@pytest.mark.parametrize("kw", [
    dict(window=6, still_elision=True),
    dict(window=6, still_elision=True, model_downscale=2),
    dict(window=6, still_elision=True, emit_frames=False,
         model_downscale=2),
    dict(window=6, still_elision=True, model_downscale=2,
         model_packed=True),
], ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_batched_still_elision_both_layouts(kw):
    pp = compare(STILLS3, **kw)
    assert pp.stats == {"concat_windows": 1, "padded_windows": 1}


@pytest.mark.parametrize("emit_frames", [True, False])
def test_keyframe_aligned_concat_and_padded_control(emit_frames):
    kw = dict(window=8, still_elision=True, model_downscale=2,
              emit_frames=emit_frames)
    pp = compare(ALIGNED2, **kw)
    assert pp.stats == {"concat_windows": 4, "padded_windows": 0}
    mid = single_key_stream()
    pp = compare([mid, mid], **kw)
    assert pp.stats == {"concat_windows": 1, "padded_windows": 2}


# the elided route's batches: (sources, window, stats)
ELIDED_BATCHES = {
    "concat": lambda: (ALIGNED2, 8, {"concat_windows": 4,
                                     "padded_windows": 0}),
    "padded": lambda: ([single_key_stream(), single_key_stream(18)], 8,
                       {"concat_windows": 1, "padded_windows": 2}),
    "mixed": lambda: (STILLS3, 6, {"concat_windows": 1,
                                   "padded_windows": 1}),
}
EMITS = {"frames": dict(emit_model_input=False),
         "both": dict(model_downscale=2),
         "model_only": dict(emit_frames=False, model_downscale=2)}


@pytest.mark.parametrize("transport", ["kmv", "bc"])
@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("emit", sorted(EMITS))
@pytest.mark.parametrize("batch", sorted(ELIDED_BATCHES))
def test_elided_rows_upload_straight_from_the_window(batch, emit, native,
                                                     transport, monkeypatch):
    """One device, B > 1, still elision, both plane transports: the
    windows and stats equal the reference's; compact_changed_batch plans
    on a [B, T] frame-index array, never on planes; every plane reaches
    the device through to_device_into as a view of the window's plane, in
    runs of consecutive frames; to_device carries no plane (bc's bcode and
    rloc go gathered by the plan's rows); the pad rows are never
    uploaded."""
    from jsplayer_tpu_torch.utils.logging import LOG

    if not native:
        no_native(monkeypatch)
    sources, window, stats = ELIDED_BATCHES[batch]()
    planned, windows_pc, into, put = [], [], [], []
    raw_plan = P.sp_recon.compact_changed_batch
    raw_rows, raw_into, raw_put = (P.upload_changed_rows, P.to_device_into,
                                   P.to_device)

    def plan(paycode, mvk, changed):
        planned.append(np.asarray(paycode))
        return raw_plan(paycode, mvk, changed)

    def rows(pc, *a, **k):
        windows_pc.append(pc)
        return raw_rows(pc, *a, **k)

    def to_into(a, out):
        assert np.shares_memory(a, windows_pc[-1])
        into.append(a.shape)
        return raw_into(a, out)

    def to_dev(a, device):
        put.append(np.asarray(a))
        return raw_put(a, device)

    monkeypatch.setattr(P.sp_recon, "compact_changed_batch", plan)
    monkeypatch.setattr(P, "upload_changed_rows", rows)
    monkeypatch.setattr(P, "to_device_into", to_into)
    monkeypatch.setattr(P, "to_device", to_dev)
    before = LOG.counters.copy()
    jp, pp = pipelines(sources, window=window, still_elision=True,
                       sp_device_path=transport, **EMITS[emit])
    assert_windows_equal(list(jp), list(pp))
    assert pp.stats == jp.stats == stats
    assert pp._sp_native is native
    got = LOG.counters - before

    B = len(sources)
    assert len(planned) == sum(stats.values())
    for a in planned:
        np.testing.assert_array_equal(
            a, np.tile(np.arange(window), (B, 1)))
    Y, X = windows_pc[0].shape[2:]
    assert all(a.shape[-2:] != (Y, X) for a in put)
    assert all(len(s) == 3 and s[1:] == (Y, X) for s in into)
    assert got["elision.direct_runs"] == len(into) > 0
    assert got["elision.direct_rows"] == sum(s[0] for s in into)
    assert got["elision.direct_rows"] == (got["frames.scanned"]
                                          - got["rows.padded"])
    assert (got["rows.padded"] > 0) == (batch != "concat")
    # the real rows' planes and the small arrays: no pad row is uploaded
    assert got["upload.calls"] == len(into) + len(put)
    assert got["upload.bytes"] == (got["elision.direct_rows"] * Y * X * 4
                                   + sum(a.nbytes for a in put))


def test_packed_model_only_single_stream():
    """model_packed with emit_frames=False.  One stream: the reference's
    batched packed model scan fails for B>1 (ROADMAP.md queue 3)."""
    compare(SP3[:1], window=4, emit_frames=False, model_downscale=2,
            model_packed=True)


@pytest.mark.parametrize("kw", [
    dict(window=4, still_elision=True),
    dict(window=4, still_elision=True, model_downscale=2),
    dict(window=6, still_elision=True, emit_frames=False),
])
def test_single_stream_still_elision(kw):
    compare(STILLS3[:1], **kw)
    compare(SP3[:1], **kw)


def test_all_stills_window():
    enc = ScreenPressorEncoder(4, 32, 32)
    f = np.full(32 * 32, 0x030201, dtype=np.uint32)
    streams = [enc.encode_i(f)] + [enc.encode_p(f) for _ in range(7)]
    g = f.copy()
    g[:32] = 0x090909
    streams.append(enc.encode_p(g))
    avi = mux_avi(streams, 32, 32, 24, codec="SPV4",
                  keyflags=[t == 0 for t in range(len(streams))])
    compare([avi, avi], window=4, still_elision=True)


@pytest.mark.parametrize("kw", [
    dict(window=4, frame_range=(6, 10)),
    dict(window=3, frame_range=(2, 9), model_downscale=2),
])
def test_frame_range(kw):
    pp = compare(SP3[:2], **kw)
    assert pp.cfg.frame_range == kw["frame_range"]


def _poison_second_stream(pipe, fail_at, setattr_through=False):
    """Make stream 1's decoder raise from its `fail_at`-th decompress call
    on (test_ingest.py's injection)."""
    decs = pipe._sp_decoders()
    bad = decs[1]
    count = [0]

    class Boom:
        def __setattr__(self, name, value):
            setattr(bad, name, value)

        def __getattr__(self, name):
            orig = getattr(bad, name)
            if name.startswith("decompress"):
                def wrap(*a, **k):
                    count[0] += 1
                    if count[0] >= fail_at:
                        raise ValueError("injected decode failure")
                    return orig(*a, **k)
                return wrap
            return orig

    pipe._spdecs = [decs[0], Boom()]


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("elide", [False, True])
def test_quarantined_bad_stream(native, elide, monkeypatch):
    if not native:
        no_native(monkeypatch)
    jp, pp = pipelines(SP3[:2], window=4, still_elision=elide)
    for p in (jp, pp):
        _poison_second_stream(p, fail_at=6)
    assert_windows_equal(list(jp), list(pp))
    assert pp.quarantined == jp.quarantined == {1}
    assert [b for b, _ in pp.quarantine_errors] == [1]


@pytest.mark.parametrize("kw", [
    dict(window=4),
    dict(window=6, still_elision=True, emit_frames=False, model_downscale=2),
])
def test_pure_python_host_branch(kw, monkeypatch):
    no_native(monkeypatch)
    avis = STILLS3[:2] if kw.get("still_elision") else SP3[:2]
    pp = compare(avis, **kw)
    assert pp._sp_native is False


def test_bpp16_model_channels():
    enc = ScreenPressorEncoder(4, 32, 32, bpp=16)
    rng = np.random.default_rng(5)
    f = np.full(32 * 32, 0x0A0B0C & 0x1F1F1F, dtype=np.uint32)
    streams = [enc.encode_i(f)]
    for _ in range(4):
        f = f.copy()
        f.reshape(32, 32)[4:8, 4:20] = int(rng.integers(0, 0x8000)) & 0x1F1F1F
        streams.append(enc.encode_p(f))
    avi = mux_avi(streams, 32, 32, 16, codec="SPV4",
                  keyflags=[t == 0 for t in range(5)])
    compare([avi], window=5)
    compare([avi, avi], window=5, model_downscale=2, emit_frames=False)


def test_mid_stream_handoff_from_reference_state():
    """Start the port from a reference pipeline's state after one window:
    its native decoders and its carry (carry_from_numpy) — the next window
    matches the reference's continuation, and carry_to_numpy round-trips."""
    kw = dict(window=4, model_downscale=2)
    ref = J.VideoIngestPipeline([MemorySource(a) for a in SP3],
                                J.IngestConfig(**kw))
    src = J.VideoIngestPipeline([MemorySource(a) for a in SP3],
                                J.IngestConfig(**kw))
    chunk = [r.frames[0:4] for r in ref.readers]
    ref._decode_sp_window(chunk, 0)
    src._decode_sp_window(chunk, 0)
    port = P.VideoIngestPipeline([MemorySource(a) for a in SP3],
                                 P.IngestConfig(device="cpu", **kw))
    port._spdecs, port._sp_native = src._sp_decoders(), src._sp_native
    port._carry = P.carry_from_numpy(np.asarray(src._carry), "cpu")
    np.testing.assert_array_equal(P.carry_to_numpy(port._carry),
                                  np.asarray(src._carry))
    for start in (4, 8):
        chunk = [r.frames[start:start + 4] for r in ref.readers]
        chunk = [c + [b""] * (4 - len(c)) for c in chunk]
        assert_windows_equal([ref._decode_sp_window(chunk, start)],
                             [port._decode_sp_window(chunk, start)])
        np.testing.assert_array_equal(P.carry_to_numpy(port._carry),
                                      np.asarray(ref._carry))


def test_ingest_cli(tmp_path, capsys):
    from jsplayer_tpu.__main__ import main as jmain
    from jsplayer_tpu_torch.__main__ import main as pmain

    files = []
    for i, avi in enumerate(STILLS3[:2]):
        p = tmp_path / f"s{i}.avi"
        p.write_bytes(avi)
        files.append(str(p))
    args = ["ingest", *files, "--window", "6", "--elide", "--downscale", "2"]
    results = {}
    for name, fn, extra in (("ref", jmain, []),
                            ("port", pmain, ["--device", "cpu"])):
        assert fn(args + extra) == 0
        cap = capsys.readouterr()
        results[name] = (json.loads(cap.out.strip().splitlines()[-1]),
                         [ln.split(" model_input ")[1].rsplit(" ", 1)[0]
                          for ln in cap.err.splitlines()
                          if " model_input " in ln])
    (rj, rshapes), (pj, pshapes) = results["ref"], results["port"]
    assert pj["streams"] == rj["streams"] == 2
    assert pj["frames_decoded"] == rj["frames_decoded"] > 0
    assert pshapes == rshapes and pshapes
    assert pj["frames_per_sec"] > 0


@pytest.mark.parametrize("what", ["path", "mesh", "msv1", "lane"])
def test_unported_paths_raise(what):
    """A mesh must be the port's own (pipeline/mesh.Mesh) on every path:
    the kmv default, kmv_sparse ("path"), MSV1 sources and lane containers
    raise TypeError for any other object."""
    srcs = [MemorySource(SP3[0])]
    kw = dict(device="cpu", mesh=object())
    if what == "path":
        kw["sp_device_path"] = "kmv_sparse"
    elif what == "msv1":
        srcs = [MemorySource(msv1_avi(1)[0])]
    elif what == "lane":
        srcs = [MemorySource(b"JLV1" + bytes(60))]
    with pytest.raises(TypeError, match="pipeline.mesh.Mesh"):
        P.VideoIngestPipeline(srcs, P.IngestConfig(**kw))


# -- the "general" and "pallas" paths (captured block commands) --------------

BLOCK_PATHS = ["general", "pallas"]


@pytest.mark.parametrize("path", BLOCK_PATHS)
@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("kw", [
    dict(window=4),
    dict(window=4, model_downscale=2),
    dict(window=3, streaming=True),
], ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_block_command_paths(path, native, kw, monkeypatch):
    """Both host branches: native decompress(capture=True) and the
    pure-Python oracle."""
    if not native:
        no_native(monkeypatch)
    pp = compare(SP3, sp_device_path=path, **kw)
    assert pp._sp_native is native


@pytest.mark.parametrize("path", BLOCK_PATHS)
def test_block_command_paths_route(path, monkeypatch):
    """"pallas" scans with the fused compose, "general" with the general
    one (on decoder-valid streams their frames agree, so the windows alone
    cannot tell)."""
    calls = []

    def spy(name, fn):
        def wrapped(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(P, "decode_batch_fused",
                        spy("pallas", P.decode_batch_fused))
    monkeypatch.setattr(P.sp_recon, "decode_batch",
                        spy("general", P.sp_recon.decode_batch))
    pipe = P.VideoIngestPipeline([MemorySource(a) for a in SP3[:2]],
                                 P.IngestConfig(device="cpu", window=4,
                                                sp_device_path=path))
    n = len(list(pipe))
    assert calls == [path] * n and n > 1


@pytest.mark.parametrize("path", BLOCK_PATHS)
def test_block_command_paths_ignore_elision_and_model_only(path):
    """As in the reference, still_elision (beyond keyframe-snapped window
    starts) and emit_frames=False do not change these paths' windows."""
    pp = compare(STILLS3, sp_device_path=path, window=6, still_elision=True,
                 emit_frames=False, model_downscale=2)
    assert pp.stats == {"concat_windows": 0, "padded_windows": 0}


@pytest.mark.parametrize("path", BLOCK_PATHS)
@pytest.mark.parametrize("kw", [
    dict(window=4, frame_range=(6, 10)),
    dict(window=3, frame_range=(2, 9), model_downscale=2),
])
def test_block_command_paths_frame_range(path, kw):
    compare(SP3[:2], sp_device_path=path, **kw)


@pytest.mark.parametrize("path", BLOCK_PATHS)
@pytest.mark.parametrize("native", [True, False])
def test_block_command_paths_quarantine(path, native, monkeypatch):
    """A stream that fails mid-run freezes; its stale pooled command rows
    never reach the frames (changed is False for them)."""
    if not native:
        no_native(monkeypatch)
    jp, pp = pipelines(SP3[:2], window=4, sp_device_path=path)
    for p in (jp, pp):
        _poison_second_stream(p, fail_at=6)
    assert_windows_equal(list(jp), list(pp))
    assert pp.quarantined == jp.quarantined == {1}


@pytest.mark.parametrize("path", ["bc", "kmv_sparse", "lane"])
def test_unported_sp_paths_raise(path):
    """bc, kmv_sparse and lane take only the port's own Mesh."""
    with pytest.raises(TypeError, match="pipeline.mesh.Mesh"):
        P.VideoIngestPipeline([MemorySource(SP3[0])],
                              P.IngestConfig(device="cpu", mesh=object(),
                                             sp_device_path=path))


# -- the "bc" path (block-command transport) ----------------------------------

@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("kw", [
    dict(window=4),
    dict(window=4, model_downscale=2),
    dict(window=4, emit_frames=False, model_downscale=2),
    dict(window=4, emit_frames=False),
    dict(window=3, streaming=True),
], ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_bc_dense_windows(native, kw, monkeypatch):
    """Dense bc windows on both host branches: native decompress_bc into
    the pooled window and the oracle through prepare_bc; emit_frames=False
    runs decode_batch_bc_model."""
    if not native:
        no_native(monkeypatch)
    pp = compare(SP3, sp_device_path="bc", **kw)
    assert pp._sp_native is native


def test_bc_packed_model_only_single_stream():
    """model_packed, emit_frames=False: one stream, since the reference's
    batched packed model scan fails for B>1 (ROADMAP.md queue 3)."""
    compare(SP3[:1], sp_device_path="bc", window=4, emit_frames=False,
            model_downscale=2, model_packed=True)


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("kw", [
    dict(window=6, still_elision=True),
    dict(window=6, still_elision=True, emit_frames=False,
         model_downscale=2),
    dict(window=6, still_elision=True, model_downscale=2,
         model_packed=True),
], ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_bc_still_elision_both_layouts(native, kw, monkeypatch):
    if not native:
        no_native(monkeypatch)
    pp = compare(STILLS3, sp_device_path="bc", **kw)
    assert pp.stats == {"concat_windows": 1, "padded_windows": 1}


def test_bc_keyframe_aligned_concat_and_padded_control():
    kw = dict(sp_device_path="bc", window=8, still_elision=True,
              model_downscale=2)
    pp = compare(ALIGNED2, **kw)
    assert pp.stats == {"concat_windows": 4, "padded_windows": 0}
    mid = single_key_stream()
    pp = compare([mid, mid], **kw)
    assert pp.stats == {"concat_windows": 1, "padded_windows": 2}


@pytest.mark.parametrize("kw", [
    dict(window=4, still_elision=True),
    dict(window=6, still_elision=True, emit_frames=False,
         model_downscale=2),
])
def test_bc_single_stream_still_elision(kw):
    """One stream takes the batched elision path (the reference's bc route
    has no single-stream branch)."""
    compare(STILLS3[:1], sp_device_path="bc", **kw)
    compare(SP3[:1], sp_device_path="bc", **kw)


def test_bc_all_stills_window():
    enc = ScreenPressorEncoder(4, 32, 32)
    f = np.full(32 * 32, 0x030201, dtype=np.uint32)
    streams = [enc.encode_i(f)] + [enc.encode_p(f) for _ in range(7)]
    g = f.copy()
    g[:32] = 0x090909
    streams.append(enc.encode_p(g))
    avi = mux_avi(streams, 32, 32, 24, codec="SPV4",
                  keyflags=[t == 0 for t in range(len(streams))])
    compare([avi, avi], sp_device_path="bc", window=4, still_elision=True)


@pytest.mark.parametrize("kw", [
    dict(window=4, frame_range=(6, 10)),
    dict(window=3, frame_range=(2, 9), model_downscale=2),
])
def test_bc_frame_range(kw):
    compare(SP3[:2], sp_device_path="bc", **kw)


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("elide", [False, True])
def test_bc_quarantine(native, elide, monkeypatch):
    """A stream that fails mid-run freezes; its stale pooled rows never
    reach the frames (changed is False for them)."""
    if not native:
        no_native(monkeypatch)
    jp, pp = pipelines(SP3[:2], sp_device_path="bc", window=4,
                       still_elision=elide)
    for p in (jp, pp):
        _poison_second_stream(p, fail_at=6)
    assert_windows_equal(list(jp), list(pp))
    assert pp.quarantined == jp.quarantined == {1}


def test_bc_ingest_cli(tmp_path, capsys):
    """`--path bc` reaches the port's bc path from the CLI."""
    from jsplayer_tpu_torch.__main__ import main as pmain

    p = tmp_path / "s.avi"
    p.write_bytes(STILLS3[0])
    assert pmain(["ingest", str(p), "--path", "bc", "--window", "6",
                  "--elide", "--downscale", "2", "--device", "cpu"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["streams"] == 1 and res["frames_decoded"] > 0

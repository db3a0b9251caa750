"""The port's kmv_sparse ingest (device="cpu", plain twins) against
jsplayer_tpu's on tests/test_ingest.py's fixtures: every key of every
window dict, bit for bit, on both host branches (the native decoder's
sparse emission and the pure-Python oracle with prepare_kmv_sparse), with
and without the rANS-coded tile payload, streaming, frame_range,
model_downscale 1/2 and model_packed; the quarantine of a window-leading
keyframe and of a mid-window frame; and reference host fault 3, which the
port's oracle branch repairs (the reference's black corner is pinned as
observed beside the port's frozen stream)."""

import json

import numpy as np
import pytest
import torch

from jsplayer_tpu_torch.core.source import MemorySource
from jsplayer_tpu_torch.pipeline import ingest as P
from test_ingest import msv1_avi, sp_avi
from test_torch_ingest import (_poison_second_stream, assert_windows_equal,
                               bits, compare, no_native, pipelines)

torch.set_num_threads(1)

SP3 = [sp_avi(s)[0] for s in (1, 2, 3)]
SPARSE = dict(sp_device_path="kmv_sparse")


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("lane", [False, True])
@pytest.mark.parametrize("kw", [
    dict(window=4),
    dict(window=5, model_downscale=2),
    dict(window=5, model_downscale=2, model_packed=True),
    dict(window=3, streaming=True),
    dict(window=4, frame_range=(6, 10)),
], ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_sparse_windows(native, lane, kw, monkeypatch):
    """window=5 makes every window keyframe-led (the dense init branch);
    window=4 and 3 start windows mid-GOP and meet mid-window keyframes
    (full-tile frames).  The oracle branch has no lane payload in the
    reference (it ships dense tiles), so there the flag changes nothing."""
    if not native:
        no_native(monkeypatch)
    pp = compare(SP3, sparse_lane_payload=lane, **SPARSE, **kw)
    assert pp._sp_native is native


def test_sparse_ignores_elision_and_model_only():
    """As in the reference, still_elision (beyond keyframe-snapped window
    starts) and emit_frames=False do not change the sparse windows."""
    from test_torch_ingest import STILLS3

    pp = compare(STILLS3, window=6, still_elision=True, emit_frames=False,
                 model_downscale=2, **SPARSE)
    assert pp.stats == {"concat_windows": 0, "padded_windows": 0}


def test_sparse_single_stream_and_sticky_bucket():
    """One stream (no thread pool), windows whose tile counts shrink: the
    sticky m_pad bucket keeps the largest, as the reference's."""
    jp, pp = pipelines(SP3[:1], window=4, **SPARSE)
    assert_windows_equal(list(jp), list(pp))
    assert pp._m_bucket == jp._m_bucket


def frames_by_time(pipe):
    """{timeline frame: [B, Y, X] u32} over a pipeline's windows."""
    outs = {}
    for w in pipe:
        fr = bits(w["frames_u32"]).view(np.uint32)
        for t in range(fr.shape[1]):
            outs[w["start_frame"] + t] = fr[:, t]
    return outs


class KeyframeBoom:
    """Stream 1's native decoder raising from its `fail_at`-th plain
    `decompress` call on (tests/test_ingest.py's window-leading keyframe
    injection: that call decodes the dense init)."""

    def __init__(self, bad, fail_at, name="decompress"):
        object.__setattr__(self, "_bad", bad)
        object.__setattr__(self, "_n", [0, fail_at, name])

    def __setattr__(self, name, value):
        setattr(self._bad, name, value)

    def __getattr__(self, name):
        orig = getattr(self._bad, name)
        n = self._n
        if name != n[2]:
            return orig

        def wrap(*a, **k):
            n[0] += 1
            if n[0] >= n[1]:
                raise ValueError("injected failure")
            return orig(*a, **k)
        return wrap


@pytest.mark.parametrize("name,fail_at", [
    ("decompress", 2),              # window 5's leading keyframe
    ("decompress_kmv_sparse", 6),   # t=7, two P-frames after keyframe 5
])
def test_native_quarantine(name, fail_at):
    """A failed window-leading keyframe starts its stream from its carry; a
    mid-window failure keeps the decoded keyframe: both equal the
    reference's windows (tests/test_ingest.py's two native cases)."""
    jp, pp = pipelines(SP3[:2], window=5, **SPARSE)
    for p in (jp, pp):
        decs = p._sp_decoders()
        p._spdecs = [decs[0], KeyframeBoom(decs[1], fail_at, name)]
    got, want = frames_by_time(pp), frames_by_time(jp)
    assert sorted(got) == sorted(want)
    for t in want:
        np.testing.assert_array_equal(got[t], want[t], err_msg=str(t))
    assert pp.quarantined == jp.quarantined == {1}
    frozen = 4 if name == "decompress" else 6
    for t in range(frozen + 1, 11):
        np.testing.assert_array_equal(got[t][1], got[frozen][1])


@pytest.mark.parametrize("native", [True, False])
def test_quarantine_at_a_window_start(native, monkeypatch):
    """A stream whose decode fails on a window's first frame (frame 4)
    freezes at frame 3 on both branches, as the reference's."""
    if not native:
        no_native(monkeypatch)
    jp, pp = pipelines(SP3[:2], window=4, **SPARSE)
    for p in (jp, pp):
        _poison_second_stream(p, fail_at=5)
    assert_windows_equal(list(jp), list(pp))
    assert pp.quarantined == jp.quarantined == {1}


def test_oracle_mid_window_quarantine_repairs_reference_fault_3(
        monkeypatch):
    """Reference host fault 3: stream 1's oracle decode fails at frame 6,
    mid-window [4, 8).  The port keeps frames 4 and 5, decoded before the
    failure, and freezes at frame 5; the reference drops their commands
    while `changed` stays True, so from frame 4 on every frame is its carry
    with a zero 16x16 tile at (0, 0) — the black corner, pinned here as
    observed.  Stream 0 is equal and right on both."""
    no_native(monkeypatch)
    (a1, g1), (a2, g2) = sp_avi(1), sp_avi(2)
    jp, pp = pipelines([a1, a2], window=4, **SPARSE)
    for p in (jp, pp):
        _poison_second_stream(p, fail_at=7)
    got, want = frames_by_time(pp), frames_by_time(jp)
    assert pp.quarantined == jp.quarantined == {1}
    assert sorted(got) == sorted(want) == list(range(12))
    for t in range(12):
        gold = g1[min(t, 10)].reshape(32, 32)
        np.testing.assert_array_equal(got[t][0], gold)
        np.testing.assert_array_equal(want[t][0], gold)
    for t in range(12):  # the port: decoded frames, then frozen at 5
        np.testing.assert_array_equal(got[t][1].reshape(-1),
                                      g2[min(t, 5)], err_msg=str(t))
    for t in range(4):
        np.testing.assert_array_equal(want[t][1].reshape(-1), g2[t])
    for t in range(4, 12):  # the reference: a black corner from frame 4
        corner = want[t][1][:16, :16]
        assert (corner == 0).all() and corner.size == 256, t
        assert not np.array_equal(want[t][1].reshape(-1), g2[min(t, 10)])


def test_sparse_lane_payload_decodes_on_the_device(monkeypatch):
    """With sparse_lane_payload the tiles go through encode_tiles and
    decode_tiles_device (the packed rANS decode), once a window with more
    than one tile row."""
    from jsplayer_tpu_torch.kernels import lane_transport

    calls = []
    real = lane_transport.decode_tiles_device

    def spy(pack, device="cuda"):
        calls.append((pack.n_tiles, pack.refills is None))
        return real(pack, device)

    monkeypatch.setattr(lane_transport, "decode_tiles_device", spy)
    pipe = P.VideoIngestPipeline(
        [MemorySource(a) for a in SP3],
        P.IngestConfig(device="cpu", window=4, sparse_lane_payload=True,
                       **SPARSE))
    n = len(list(pipe))
    assert n == 3 and len(calls) == n
    assert all(s > 1 and packed for s, packed in calls)


@pytest.mark.parametrize("mesh_path", ["kmv_sparse", "msv1"])
def test_sparse_and_msv1_refuse_a_mesh(mesh_path):
    """Under a dp=2 mesh of CPU slots, kmv_sparse decodes unsharded (its
    windows equal the port's own without a mesh, as the reference takes no
    mesh branch there) and MSV1 shards its streams (its windows equal the
    JAX package's over the same mesh of virtual CPU devices)."""
    import jax
    from jsplayer_tpu.core.source import MemorySource as JSource
    from jsplayer_tpu.pipeline import ingest as J
    from jsplayer_tpu.pipeline.mesh import make_mesh as j_make_mesh
    from jsplayer_tpu_torch.pipeline.mesh import make_mesh

    mesh = make_mesh(dp=2, devices=["cpu"] * 2)
    if mesh_path == "kmv_sparse":
        kw = dict(window=4, **SPARSE)
        want = list(P.VideoIngestPipeline(
            [MemorySource(a) for a in SP3[:2]],
            P.IngestConfig(device="cpu", **kw)))
        avis = SP3[:2]
    else:
        kw = dict(window=4)
        avis = [msv1_avi(s)[0] for s in (1, 2)]
        want = list(J.VideoIngestPipeline(
            [JSource(a) for a in avis],
            J.IngestConfig(mesh=j_make_mesh(dp=2, devices=jax.devices()[:2]),
                           **kw)))
    got = list(P.VideoIngestPipeline(
        [MemorySource(a) for a in avis],
        P.IngestConfig(device="cpu", mesh=mesh, **kw)))
    assert_windows_equal(want, got)


def test_unknown_path_raises():
    with pytest.raises(ValueError, match="sp_device_path"):
        P.VideoIngestPipeline([MemorySource(SP3[0])],
                              P.IngestConfig(device="cpu",
                                             sp_device_path="nope"))


def test_sparse_and_msv1_ingest_cli(tmp_path, capsys):
    """`--path kmv_sparse --lane-payload` and an MSV1 AVI reach the port's
    paths from the CLI."""
    from jsplayer_tpu_torch.__main__ import main as pmain

    files = []
    for i, avi in enumerate((SP3[0], msv1_avi(1)[0])):
        p = tmp_path / f"s{i}.avi"
        p.write_bytes(avi)
        files.append(str(p))
    for args in (["ingest", files[0], files[0], "--path", "kmv_sparse",
                  "--lane-payload", "--window", "4", "--downscale", "2"],
                 ["ingest", files[1], "--window", "4"]):
        assert pmain(args + ["--device", "cpu"]) == 0
        res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert res["frames_decoded"] >= 11

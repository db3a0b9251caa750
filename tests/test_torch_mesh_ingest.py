"""The port's ingest over a (dp, gop) mesh of CPU slots against the JAX
package's over the same mesh of tests/conftest.py's 8 virtual CPU devices,
on the same sources, window dict by window dict, bit for bit: kmv and bc
on dp (dense and still-elided), kmv and bc gop grouping, lane containers
on dp and gop (raw and rANS, dense and still-elided, a mid-GOP fallback, a
ragged group), MSV1 on dp; kmv_sparse, general and pallas decode unsharded
under a mesh, as in the reference; and the errors a mesh raises.  The
fixtures are the makers of the reference's tests."""

import jax
import numpy as np
import pytest
import torch

from jsplayer_tpu.core.source import MemorySource
from jsplayer_tpu.encode.avi_mux import mux_avi
from jsplayer_tpu.encode.sp_enc import ScreenPressorEncoder, pack_rgb
from jsplayer_tpu.pipeline import ingest as J
from jsplayer_tpu.pipeline import mesh as JM
from jsplayer_tpu.transcode import transcode_to_lane
from jsplayer_tpu_torch.pipeline import ingest as P
from jsplayer_tpu_torch.pipeline import mesh as PM
from test_ingest import msv1_avi, sp_avi, sp_avi_stills
from test_lane_container import make_avi
from test_torch_ingest import assert_windows_equal, no_native

torch.set_num_threads(1)


def meshes(dp, gop):
    """The reference's mesh over the virtual CPU devices, and the port's
    over as many CPU slots."""
    n = dp * gop
    return (JM.make_mesh(dp=dp, gop=gop, devices=jax.devices()[:n]),
            PM.make_mesh(dp=dp, gop=gop, devices=[torch.device("cpu")] * n))


def compare(sources, dp, gop=1, **kw):
    """Both pipelines over the sources on a (dp, gop) mesh → the port's
    pipeline and its windows."""
    jm, pm = meshes(dp, gop)
    jp = J.VideoIngestPipeline([MemorySource(s) for s in sources],
                               J.IngestConfig(mesh=jm, **kw))
    pp = P.VideoIngestPipeline([MemorySource(s) for s in sources],
                               P.IngestConfig(mesh=pm, device="cpu", **kw))
    ref, port = list(jp), list(pp)
    assert_windows_equal(ref, port)
    if hasattr(jp, "stats"):
        assert pp.stats == jp.stats
    assert pp.quarantined == jp.quarantined
    return pp, port


SP8 = [sp_avi(s)[0] for s in range(1, 9)]
STILLS8 = [sp_avi_stills(s + 20)[0] for s in range(8)]
MSV8 = [msv1_avi(s)[0] for s in range(1, 9)]


# -- kmv on dp (tests/test_ingest.py:540, :774) -------------------------------

@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("kw", [
    dict(window=4),
    dict(window=4, model_downscale=2),
    dict(window=4, emit_frames=False),
], ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_kmv_dp(native, kw, monkeypatch):
    """tests/test_ingest.py:540: 8 streams over a dp=8 mesh, both host
    branches (the oracle's capture goes through prepare_kmv)."""
    if not native:
        no_native(monkeypatch)
    pp, _ = compare(SP8, 8, **kw)
    assert pp._sp_native is native


def spy_slot_uploads(monkeypatch):
    """Record what still elision under a mesh does with its windows: each
    window's plane (entering _plane_elided), each plan's frame-index input
    and result (compact_changed_batch), and each upload_changed_rows call
    with the counts of windows and plans seen before it."""
    rec = dict(planes=[], planned=[], uploads=[])
    raw_plan, raw_rows = P.sp_recon.compact_changed_batch, \
        P.upload_changed_rows
    raw_elided = P.VideoIngestPipeline._plane_elided

    def elided(self, tr, arrays, *a):
        rec["planes"].append(arrays[0])
        return raw_elided(self, tr, arrays, *a)

    def plan(paycode, mvk, changed):
        rec["planned"].append(np.asarray(paycode))
        rec["planned"].append(raw_plan(paycode, mvk, changed))
        return rec["planned"][-1]

    def rows(pc, idx, counts, device, cpad=None):
        rec["uploads"].append((len(rec["planes"]), len(rec["planned"]), pc,
                               idx, counts, device, cpad))
        return raw_rows(pc, idx, counts, device, cpad)

    monkeypatch.setattr(P.VideoIngestPipeline, "_plane_elided", elided)
    monkeypatch.setattr(P.sp_recon, "compact_changed_batch", plan)
    monkeypatch.setattr(P, "upload_changed_rows", rows)
    return rec


def check_slot_uploads(rec, pp, dp, B, window):
    """Every elided window took the PADDED layout; compact_changed_batch
    planned on a [B, T] frame-index array, never on planes; and
    upload_changed_rows ran once a slot a window, in slot order, on the
    slot's device, over views of the window's plane and of the plan's
    rows at the slot's first stream."""
    bs = B // dp
    assert pp.stats["concat_windows"] == 0 and pp.stats["padded_windows"]
    indices, plans = rec["planned"][::2], rec["planned"][1::2]
    assert len(indices) == pp.stats["padded_windows"]
    for a in indices:
        np.testing.assert_array_equal(a, np.tile(np.arange(window), (B, 1)))
    assert len(rec["uploads"]) == dp * pp.stats["padded_windows"]

    def first_row(view, whole):
        """The leading row of `whole` at which `view` starts."""
        assert np.shares_memory(view, whole)
        off = (view.__array_interface__["data"][0]
               - whole.__array_interface__["data"][0])
        assert off % whole.strides[0] == 0
        return off // whole.strides[0]

    for k, (w, n, pc, idx, counts, device, cpad) in enumerate(
            rec["uploads"]):
        slot = k % dp
        whole_pc = rec["planes"][w - 1]
        plan_rows, _, valid, _ = plans[n // 2 - 1]
        assert device == torch.device("cpu") and cpad == plan_rows.shape[1]
        assert pc.shape == (bs, window) + whole_pc.shape[2:]
        assert first_row(pc, whole_pc) == first_row(idx, plan_rows) == \
            slot * bs
        np.testing.assert_array_equal(
            counts, valid[slot * bs:(slot + 1) * bs].sum(axis=1))


@pytest.mark.parametrize("kw", [
    dict(window=6, still_elision=True),
    dict(window=6, still_elision=True, emit_frames=False,
         model_downscale=2),
    dict(dp=4, window=6, still_elision=True),
], ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_kmv_elided_dp(kw, monkeypatch):
    """tests/test_ingest.py:774: still-elision under a mesh takes the
    PADDED layout (every window) through the sharded step.  As on one
    device, compact_changed_batch plans on a [B, T] frame-index array,
    never on planes, and the changed planes go straight from the window:
    upload_changed_rows runs once a slot a window, in slot order, on the
    slot's device, over views of the window's pc and of the plan's rows
    at the slot's first stream (dp=8: one stream a slot; dp=4: two)."""
    kw = dict(kw)
    dp = kw.pop("dp", 8)
    rec = spy_slot_uploads(monkeypatch)
    pp, port = compare(STILLS8, dp, **kw)
    check_slot_uploads(rec, pp, dp, len(STILLS8), kw["window"])
    if kw.get("emit_frames", True):
        assert any(w["frames_u32"].shape[0] < kw["window"] * len(STILLS8)
                   for w in port)


def test_kmv_dp_two_streams_a_slot():
    """8 streams on a dp=4 mesh: each slot scans two streams in one
    batch."""
    compare(SP8, 4, window=4)


# -- MSV1 on dp (tests/test_ingest.py:866) ------------------------------------

@pytest.mark.parametrize("kw", [dict(window=4),
                                dict(window=4, insignificant_lines=5)],
                         ids=["plain", "insignificant_lines"])
def test_msv1_dp(kw):
    """MSV1 over a dp=8 mesh, the window carry threaded through the
    sharded step: it equals the JAX package's."""
    compare(MSV8, 8, **kw)


# -- bc (tests/test_bc_transport.py:177, :189) ---------------------------------

BC8 = [make_avi(s, 48, 32, 6)[0] for s in range(8)]


@pytest.mark.parametrize("kw", [dict(window=3),
                                dict(window=3, still_elision=True)],
                         ids=["dense", "elided"])
def test_bc_dp(kw, monkeypatch):
    """bc on a dp=8 mesh; still-elided, each slot uploads its own
    streams' changed planes, as kmv's do."""
    rec = spy_slot_uploads(monkeypatch)
    pp, _ = compare(BC8, 8, sp_device_path="bc", **kw)
    if kw.get("still_elision"):
        check_slot_uploads(rec, pp, 8, len(BC8), kw["window"])
    else:
        assert rec == dict(planes=[], planned=[], uploads=[])


@pytest.mark.parametrize("path", ["bc", "kmv"])
def test_gop_grouping_bc_and_kmv(path):
    """tests/test_bc_transport.py:189: G=2 keyframe-led windows a sharded
    [B, G, T] dispatch on a (4, 2) mesh, for bc and kmv."""
    avis = [make_avi(s, 48, 32, 12, key_every=3)[0] for s in range(4)]
    _, port = compare(avis, 4, 2, window=3, sp_device_path=path)
    assert [w["start_frame"] for w in port] == [0, 3, 6, 9]


def _grouped_streams():
    """tests/test_pipeline.py:211's streams: 22 frames, keyframes every
    4, scrolls and changed rows."""
    X = Y = 32
    rng = np.random.default_rng(9)

    def build(seed):
        enc = ScreenPressorEncoder(4, X, Y)
        f = np.full((Y, X), pack_rgb(seed, 3, 5), dtype=np.uint32)
        streams = []
        for t in range(22):
            f = f.copy()
            if t % 3 == 1:
                f[2:, :] = f[:-2, :]
            f[(t % 5) * 5: (t % 5) * 5 + 4, 6:26] = pack_rgb(
                *rng.integers(0, 256, 3))
            flat = f.reshape(-1)
            streams.append(enc.encode_i(flat) if t % 4 == 0
                           else enc.encode_p(flat))
        return mux_avi(streams, X, Y, 24, codec="SPV4",
                       keyflags=[t % 4 == 0 for t in range(22)])

    return [build(s) for s in (1, 2)]


@pytest.mark.parametrize("kw", [dict(), dict(model_downscale=2)],
                         ids=["frames", "ds2"])
def test_gop_grouped_windows_with_carry_and_stream_end(kw):
    """tests/test_pipeline.py:211: a (2, 4) mesh, 6 windows in 2 groups
    (the carry into the next group, stream-end padding)."""
    _, port = compare(_grouped_streams(), 2, 4, window=4, **kw)
    assert len(port) == 6


@pytest.mark.parametrize("path", ["kmv", "bc"])
def test_gop_group_carry_into_a_mid_gop_group_start(path):
    """Keyframes at 0, 4 and 12, windows of 4, G=2: the second group's
    first window (frames 8-11) continues frame 7's GOP, so it starts from
    the carry, the last frame of the first group's LAST window."""
    avis = [_keyed_avi(s, key_at=(0, 4, 12), T=16) for s in range(4)]
    _, port = compare(avis, 4, 2, window=4, sp_device_path=path)
    assert [w["start_frame"] for w in port] == [0, 4, 8, 12]


# -- lane containers (tests/test_lane_container.py:100, :379, :432, :1013) ------

def lane8(payload):
    return [transcode_to_lane(make_avi(s, 48, 32, 6, key_every=3)[0],
                              window=3, K=2, payload=payload)
            for s in range(8)]


@pytest.mark.parametrize("payload", ["raw", "rans"])
@pytest.mark.parametrize("elide", [False, True])
def test_lane_dp(payload, elide):
    compare(lane8(payload), 8, sp_device_path="lane", still_elision=elide)


@pytest.mark.parametrize("payload", ["raw", "rans"])
@pytest.mark.parametrize("elide", [False, True])
def test_lane_gop_grouping(payload, elide):
    """Restart windows over the gop axis: G=2 windows of 3 frames a
    dispatch, emitted as one 6-frame window."""
    conts = [transcode_to_lane(make_avi(s, 64, 48, 12, key_every=3)[0],
                               window=3, K=2, payload=payload)
             for s in range(4)]
    _, port = compare(conts, 4, 2, sp_device_path="lane",
                      still_elision=elide)
    assert [w["start_frame"] for w in port] == [0, 6]


def test_lane_gop_mid_gop_fallback():
    """One keyframe: every window is carry-dependent, so none groups."""
    conts = [transcode_to_lane(make_avi(s, 64, 48, 12)[0], window=3, K=2)
             for s in range(4)]
    _, port = compare(conts, 4, 2, sp_device_path="lane")
    assert [(w["start_frame"], w["frames_u32"].shape[1]) for w in port] \
        == [(0, 3), (3, 3), (6, 3), (9, 3)]


def _keyed_avi(seed, key_at=(0, 4, 9), T=14, X=48, Y=32):
    """tests/test_lane_container.py:1013's stream (keyframes at 0, 4, 9),
    or its recipe with other keyframes and length."""
    rng = np.random.default_rng(seed)
    enc = ScreenPressorEncoder(4, X, Y)
    f = np.full((Y, X), pack_rgb(9, 9, seed), dtype=np.uint32)
    streams, keys = [], []
    for t in range(T):
        isk = t in key_at
        if not isk and t % 3 != 2:
            f = f.copy()
            f[(t % 4) * 6: (t % 4) * 6 + 5, 4:20] = pack_rgb(
                *rng.integers(0, 256, 3))
        if isk:
            enc = ScreenPressorEncoder(4, X, Y)
            streams.append(enc.encode_i(f.reshape(-1).copy()))
        else:
            streams.append(enc.encode_p(f.reshape(-1).copy()))
        keys.append(isk)
    return mux_avi(streams, X, Y, 24, codec="SPV4", keyflags=keys)


@pytest.mark.parametrize("payload", ["raw", "rans"])
@pytest.mark.parametrize("kw", [dict(), dict(still_elision=True),
                                dict(model_downscale=2)],
                         ids=["dense", "elided", "ds2"])
def test_lane_ragged_gop_group(payload, kw):
    """Restart windows of 4, 5 and 5 frames: the first two share one
    dispatch (ragged), the third goes alone."""
    conts = [transcode_to_lane(_keyed_avi(s), window=5, K=2,
                               payload=payload) for s in range(4)]
    _, port = compare(conts, 4, 2, sp_device_path="lane", **kw)
    assert [w["start_frame"] for w in port] == [0, 9]


# -- paths that decode unsharded under a mesh ---------------------------------

@pytest.mark.parametrize("path", ["kmv_sparse", "general", "pallas"])
def test_unsharded_paths_ignore_the_mesh(path):
    """As in the reference, kmv_sparse, general and pallas take no mesh
    branch: under a dp=2 mesh they equal the JAX package's and the port's
    own unsharded decode."""
    _, port = compare(SP8[:2], 2, window=4, sp_device_path=path)
    plain = list(P.VideoIngestPipeline(
        [MemorySource(a) for a in SP8[:2]],
        P.IngestConfig(window=4, sp_device_path=path, device="cpu")))
    assert_windows_equal(port, plain)


def test_kmv_sparse_ignores_a_gop_mesh_with_elision():
    """kmv_sparse under a gop=2 mesh with still_elision: no sharding and,
    as in the reference, no keyframe snapping of the windows."""
    compare(SP8[:2], 1, 2, window=4, sp_device_path="kmv_sparse",
            still_elision=True)


# -- errors --------------------------------------------------------------------

def test_indivisible_batch_raises():
    """3 streams on a dp=2 mesh: jax.device_put raises, so does the port."""
    jm, pm = meshes(2, 1)
    srcs = [MemorySource(a) for a in SP8[:3]]
    with pytest.raises(ValueError):
        list(J.VideoIngestPipeline(srcs, J.IngestConfig(window=4, mesh=jm)))
    with pytest.raises(ValueError, match="dp"):
        list(P.VideoIngestPipeline(srcs, P.IngestConfig(
            window=4, mesh=pm, device="cpu")))


@pytest.mark.parametrize("what", ["msv1", "elision", "bc_elision"])
def test_gop_mesh_refusals(what):
    """A gop>1 mesh with MSV1, or with still-elision on the SP paths,
    raises in both packages."""
    jm, pm = meshes(1, 2)
    srcs, kw = [MemorySource(MSV8[0])], dict(window=4)
    if what != "msv1":
        srcs = [MemorySource(SP8[0])]
        kw["still_elision"] = True
        if what == "bc_elision":
            kw["sp_device_path"] = "bc"
    with pytest.raises(AssertionError):
        list(J.VideoIngestPipeline(srcs, J.IngestConfig(mesh=jm, **kw)))
    with pytest.raises(ValueError, match="gop>1"):
        list(P.VideoIngestPipeline(srcs, P.IngestConfig(
            mesh=pm, device="cpu", **kw)))


def test_gop_mesh_without_the_native_host_stage_raises(monkeypatch):
    """Grouping needs the native decoder; without it a gop>1 mesh reaches
    the dp-only step and raises in both packages."""
    no_native(monkeypatch)
    jm, pm = meshes(1, 2)
    srcs = [MemorySource(SP8[0])]
    with pytest.raises(AssertionError):
        list(J.VideoIngestPipeline(srcs, J.IngestConfig(window=4, mesh=jm)))
    with pytest.raises(ValueError, match="dp only"):
        list(P.VideoIngestPipeline(srcs, P.IngestConfig(
            window=4, mesh=pm, device="cpu")))


def test_gop_group_needs_keyframe_led_windows():
    """Windows that start mid-GOP cannot ride the gop axis."""
    jm, pm = meshes(1, 2)
    srcs = [MemorySource(SP8[0])]  # keyframes every 5, windows of 4
    with pytest.raises(AssertionError, match="keyframe-led"):
        list(J.VideoIngestPipeline(srcs, J.IngestConfig(window=4, mesh=jm)))
    with pytest.raises(ValueError, match="keyframe-led"):
        list(P.VideoIngestPipeline(srcs, P.IngestConfig(
            window=4, mesh=pm, device="cpu")))


def test_mesh_device_must_match():
    """A mesh of card slots with device="cpu" raises; the mesh itself
    touches no card."""
    cuda = np.empty((1, 1), dtype=object)
    cuda[0, 0] = torch.device("cuda", 0)
    pm = PM.Mesh(cuda, np.zeros((1, 1), dtype=int))
    with pytest.raises(ValueError, match="does not match"):
        P.VideoIngestPipeline([MemorySource(SP8[0])],
                              P.IngestConfig(mesh=pm, device="cpu"))


# -- the reference's NamedSharding helpers (pipeline/mesh.py:61-72) ----------

def _bounds(index, shape):
    """A tuple of slices → [(start, stop)] over `shape`."""
    return [s.indices(n)[:2] for s, n in zip(index, shape)]


@pytest.mark.parametrize("dp,gop", [(8, 1), (4, 2), (2, 4), (1, 8)])
@pytest.mark.parametrize("helper,shape", [
    ("stream_sharding", (8, 16, 3)), ("batch_sharding", (16, 5)),
    ("replicated", (6, 4))])
def test_placement_helpers_match_named_sharding(helper, shape, dp, gop):
    """Each slot (i, j) holds the part that the reference's NamedSharding
    puts on device i * gop + j of its mesh over the 8 CPU devices; the
    slots bg_slots and row_slots run hold those parts too."""
    jm, pm = meshes(dp, gop)
    want = getattr(JM, helper)(jm).devices_indices_map(shape)
    got = getattr(PM, helper)(pm).indices(shape)
    assert len(got) == len(want) == 8
    for (i, j), index in got.items():
        dev = jm.devices[i, j]
        assert _bounds(index, shape) == _bounds(want[dev], shape), (i, j)
    if helper == "stream_sharding":
        for slot, (rows, cols) in PM.bg_slots(pm, *shape[:2]).items():
            assert got[slot][:2] == (rows, cols)
    elif helper == "batch_sharding":
        ran = PM.row_slots(pm, shape[0], axes=PM.batch_sharding(pm).spec)
        assert sorted(ran) == [(i, 0) for i in range(dp)]
        for slot, rows in ran.items():
            assert got[slot][0] == rows


def test_placement_of_an_axis_the_mesh_does_not_divide_raises():
    _, pm = meshes(4, 2)
    with pytest.raises(ValueError, match="do not divide"):
        PM.stream_sharding(pm).indices((6, 4))
    with pytest.raises(ValueError, match="do not divide"):
        PM.batch_sharding(pm).indices((2, 4))
    assert PM.replicated(pm).indices((3,))[(3, 1)] == (slice(0, 3),)

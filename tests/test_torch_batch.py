"""The port's (dp, gop) mesh (pipeline/mesh.py) and sharded steps
(pipeline/batch.py, kernels/lane_recon.make_lane_decode_step) on CPU slots
against the JAX package's on tests/conftest.py's 8 virtual CPU devices,
with the same numpy inputs, bit for bit (the twins of
tests/test_pipeline.py's mesh tests); the copied stack_msv1_commands by
its source text and outputs; the mesh's layout, psum and errors; and the
port's dry run on 8 CPU slots."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jsplayer_tpu.codecs.msvideo1 import from_rgb15
from jsplayer_tpu.encode.msv1_enc import encode_frame_16
from jsplayer_tpu.kernels import lane_recon as JL
from jsplayer_tpu.kernels import sp_recon as JS
from jsplayer_tpu.pipeline import batch as JB
from jsplayer_tpu.pipeline import mesh as JM
from jsplayer_tpu_torch.kernels import lane_recon as PL
from jsplayer_tpu_torch.pipeline import batch as PB
from jsplayer_tpu_torch.pipeline import mesh as PM
from test_pipeline import sp_stream
from test_torch_ingest import bits

torch.set_num_threads(1)

X = Y = 32
CPU = torch.device("cpu")


def meshes(dp, gop):
    n = dp * gop
    return (JM.make_mesh(dp=dp, gop=gop, devices=jax.devices()[:n]),
            PM.make_mesh(dp=dp, gop=gop, devices=[CPU] * n))


def assert_same(ref, port):
    """A step's output(s) of either package, bit for bit."""
    if isinstance(ref, tuple):
        assert len(ref) == len(port)
        for a, b in zip(ref, port):
            assert_same(a, b)
        return
    a, b = bits(ref), bits(port)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_array_equal(b, a)


def gop_streams(B, G, Tg, seed):
    """B streams of G independent keyframe-led GOPs of Tg frames
    (tests/test_pipeline.py:87's), stacked by the reference."""
    rng = np.random.default_rng(seed)
    streams = []
    for _ in range(B):
        s_all = []
        for _ in range(G):
            s, _ = sp_stream(rng, Tg, with_motion=True)
            s_all += s
        streams.append(s_all)
    return JB.stack_sp_commands(streams, X, Y, gops=G)


def kmv_inputs(cmds, K=2):
    B, G, Tg = cmds["changed"].shape
    pcs = np.zeros((B, G, Tg, Y, X), dtype=np.uint32)
    mvks = np.zeros((B, G, Tg, K, 2), dtype=np.int32)
    for b in range(B):
        for g in range(G):
            pcs[b, g], mvks[b, g] = JS.prepare_kmv(
                cmds["bts"][b, g], cmds["mv"][b, g], cmds["rect"][b, g],
                cmds["payload"][b, g], K=K)
    return pcs, mvks


MESHES = [(4, 2), (8, 1), (2, 2), (1, 1)]


@pytest.mark.parametrize("dp,gop", MESHES)
@pytest.mark.parametrize("model", [False, True])
def test_general_step(dp, gop, model):
    """tests/test_pipeline.py:87: captured commands of keyframe-led GOPs →
    frames (or model tensors) and significance."""
    cmds = gop_streams(8, 2, 3, seed=2)
    args = [cmds[k] for k in ("bts", "mv", "rect", "payload", "changed")]
    jm, pm = meshes(dp, gop)
    ref = JB.make_sp_decode_step(jm, JB.DecodeConfig(
        height=Y, width=X, emit_model_input=model, insignificant_blocks=1))(
            *map(jnp.array, args))
    port = PB.make_sp_decode_step(pm, PB.DecodeConfig(
        height=Y, width=X, emit_model_input=model, insignificant_blocks=1))(
            *args)
    assert_same(ref, port)


@pytest.mark.parametrize("dp,gop", MESHES)
@pytest.mark.parametrize("model", [False, True])
def test_kmv_and_bc_steps(dp, gop, model):
    """tests/test_pipeline.py:160: the kmv step equals the reference's (and
    the general step), the bc step equals the reference's, from a non-zero
    carry."""
    cmds = gop_streams(8, 2, 3, seed=4)
    pcs, mvks = kmv_inputs(cmds)
    rng = np.random.default_rng(5)
    init = rng.integers(0, 1 << 24, (8, 2, Y, X)).astype(np.uint32)
    jm, pm = meshes(dp, gop)
    jcfg = JB.DecodeConfig(height=Y, width=X, emit_model_input=model)
    pcfg = PB.DecodeConfig(height=Y, width=X, emit_model_input=model)
    ref = JB.make_sp_decode_step_kmv(jm, jcfg)(
        jnp.array(init), jnp.array(pcs), jnp.array(mvks),
        jnp.array(cmds["changed"]))
    port = PB.make_sp_decode_step_kmv(pm, pcfg)(init, pcs, mvks,
                                                cmds["changed"])
    assert_same(ref, port)
    bc = [np.zeros((8, 2) + s, dtype=d) for s, d in (
        ((3, Y, X), np.uint32), ((3, 4), np.uint8), ((3, 4, 4), np.uint8),
        ((3, 2, 2), np.int32))]
    for b in range(8):
        for g in range(2):
            got = JS.prepare_bc(cmds["bts"][b, g], cmds["mv"][b, g],
                                cmds["rect"][b, g], cmds["payload"][b, g],
                                K=2)
            for a, v in zip(bc, got):
                a[b, g] = v
    ref = JB.make_sp_decode_step_bc(jm, jcfg)(
        jnp.array(init), *map(jnp.array, bc), jnp.array(cmds["changed"]))
    port = PB.make_sp_decode_step_bc(pm, pcfg)(init, *bc, cmds["changed"])
    assert_same(ref, port)


def msv1_streams(B, T, seed):
    """tests/test_pipeline.py:119's streams: painted 4x4 blocks."""
    rng = np.random.default_rng(seed)
    streams = []
    for _ in range(B):
        f = np.zeros((Y, X), dtype=np.uint32)
        f[:] = from_rgb15(int(rng.integers(0, 0x8000)))
        ss, prev = [], None
        for _ in range(T):
            f = f.copy()
            x0 = int(rng.integers(0, X - 4)) & ~3
            y0 = int(rng.integers(0, Y - 4)) & ~3
            f[y0: y0 + 4, x0: x0 + 4] = from_rgb15(
                int(rng.integers(0, 0x8000)))
            flat = f.reshape(-1)
            ss.append(encode_frame_16(flat, prev, X, Y))
            prev = flat
        streams.append(ss)
    return streams


@pytest.mark.parametrize("dp,gop", MESHES)
@pytest.mark.parametrize("carry", [False, True])
def test_msv1_step(dp, gop, carry):
    """tests/test_pipeline.py:119: the MSV1 step with the model epilogue
    (and insignificant bands), with and without a carried frame."""
    cmds = JB.stack_msv1_commands(msv1_streams(8, 8, seed=3), X, Y, gops=2)
    args = [cmds[k] for k in ("btype", "sel", "colors", "changes")]
    jm, pm = meshes(dp, gop)
    kw = dict(height=Y, width=X, emit_model_input=True,
              insignificant_blocks=2, insignificant_lines=5)
    if carry:
        rng = np.random.default_rng(6)
        init = rng.integers(0, 1 << 24, (8, 2, Y, X)).astype(np.uint32)
        valid = rng.integers(0, 2, (8, 2)).astype(bool)
        args = [init, valid] + args
    ref = JB.make_msv1_decode_step(jm, JB.DecodeConfig(**kw),
                                   with_carry=carry)(*map(jnp.array, args))
    port = PB.make_msv1_decode_step(pm, PB.DecodeConfig(**kw),
                                    with_carry=carry)(*args)
    assert_same(ref, port)


@pytest.mark.parametrize("raw", [True, False])
@pytest.mark.parametrize("axes,dp,gop", [(("dp",), 4, 2),
                                         (("dp", "gop"), 4, 2),
                                         (("dp",), 8, 1)])
def test_lane_step(raw, axes, dp, gop):
    """kernels/lane_recon.py:167: the sharded lane decode of 8 entries,
    a window of 8 lane containers as the port's ingest buckets it
    (_lane_group), from a random carry."""
    from jsplayer_tpu.core.source import MemorySource
    from jsplayer_tpu.transcode import transcode_to_lane
    from jsplayer_tpu_torch.pipeline import ingest as P
    from test_lane_container import make_avi

    conts = [transcode_to_lane(make_avi(s, 48, 32, 6, key_every=3)[0],
                               window=3, K=2,
                               payload="raw" if raw else "rans")
             for s in range(8)]
    pipe = P.VideoIngestPipeline([MemorySource(c) for c in conts],
                                 P.IngestConfig(sp_device_path="lane",
                                                device="cpu"))
    h = pipe._lane_group(1, [3], raw)
    data = ([h["payload"]] if raw else
            [h[k] for k in ("refills", "states", "freq")])
    cmds = [h[k] for k in ("btype", "rect", "mvk", "row_table", "row_idx",
                           "changed")]
    rng = np.random.default_rng(7)
    init = rng.integers(0, 1 << 24, (8, 32, 48)).astype(np.uint32)
    jm, pm = meshes(dp, gop)
    ref = JL.make_lane_decode_step(jm, h["u_pad"], axes=axes, raw=raw)(
        *map(jnp.array, [init] + data + cmds))
    port = PL.make_lane_decode_step(pm, h["u_pad"], axes=axes, raw=raw)(
        init, *data, *cmds)
    assert_same(ref, port)


def test_indivisible_batch_or_gop_raises():
    """B that dp does not divide, or G that gop does not: jax.device_put
    raises in the reference, ValueError in the port."""
    cmds = gop_streams(4, 3, 2, seed=8)
    pcs, mvks = kmv_inputs(cmds)
    init = np.zeros((4, 3, Y, X), np.uint32)
    cfg = PB.DecodeConfig(height=Y, width=X)
    for dp, gop, axis in ((8, 1, "dp"), (2, 2, "gop")):
        jm, pm = meshes(dp, gop)
        with pytest.raises(ValueError):
            JB.make_sp_decode_step_kmv(jm, JB.DecodeConfig(
                height=Y, width=X))(*map(jnp.array, (
                    init, pcs, mvks, cmds["changed"])))
        with pytest.raises(ValueError, match=axis):
            PB.make_sp_decode_step_kmv(pm, cfg)(init, pcs, mvks,
                                                cmds["changed"])
    _, pm = meshes(4, 2)
    with pytest.raises(ValueError, match=r"\(dp, gop\)"):
        PM.run_rows(pm, lambda x: x, np.zeros((12, 2)), axes=("dp", "gop"))


@pytest.mark.parametrize("native", [True, False])
def test_stack_msv1_commands_copy(native, monkeypatch):
    """The copy's source text is the reference's, and so are its stacks on
    both host branches (the native parse and the oracle's)."""
    assert inspect.getsource(PB.stack_msv1_commands) == \
        inspect.getsource(JB.stack_msv1_commands)
    if not native:
        from jsplayer_tpu import native as j_native
        from jsplayer_tpu_torch import native as p_native

        for mod in (j_native, p_native):
            monkeypatch.setattr(mod, "available", lambda: False)
    streams = msv1_streams(3, 4, seed=11)
    got = PB.stack_msv1_commands(streams, X, Y, gops=2)
    want = JB.stack_msv1_commands(streams, X, Y, gops=2)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_mesh_layout():
    """dp x gop slots in the reference's order; a device may repeat; the
    reference's dp*gop check; no CUDA device and no `devices` raises."""
    jm, pm = meshes(4, 2)
    assert pm.axis_names == jm.axis_names
    assert pm.shape == dict(jm.shape)
    assert pm.devices.shape == jm.devices.shape == (4, 2)
    assert pm.local_slots == [(i, j) for i in range(4) for j in range(2)]
    assert pm.device == CPU and pm.local_rows(8) == range(8)
    assert PM.make_mesh(gop=4, devices=["cpu"] * 8).shape == \
        {"dp": 2, "gop": 4}
    with pytest.raises(ValueError, match="ndevices"):
        PM.make_mesh(dp=3, gop=2, devices=["cpu"] * 8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PM.make_mesh()
    assert PM.row_slots(pm, 8, ("dp",)) == {
        (i, 0): slice(2 * i, 2 * i + 2) for i in range(4)}
    assert PM.row_slots(pm, 16, ("dp", "gop"))[(3, 1)] == slice(14, 16)
    assert PM.bg_slots(pm, 8, 4)[(1, 1)] == (slice(2, 4), slice(2, 4))


def test_psum():
    """The sum over the slots' values, on the mesh's device."""
    _, pm = meshes(4, 2)
    got = pm.psum([torch.tensor(k) for k in range(8)])
    assert got.device == CPU and int(got) == 28


BG_COUNTERS = ("mesh.dispatches", "mesh.slot_launches",
               "mesh.exchange_bytes", "upload.bytes", "upload.calls")


def _bg_call(a):
    """run_bg on a (4, 2) mesh of CPU slots of fn(a, c) = 2a + c over
    [8, 2, 3] int32 inputs `a` and a carry c [8, 2] held as a tensor on
    the gather slot's device → (the result, what the call added to the
    counters)."""
    from jsplayer_tpu_torch.utils.logging import LOG

    _, pm = meshes(4, 2)
    c = torch.arange(16, dtype=torch.int32).reshape(8, 2)
    before = {k: LOG.counters[k] for k in BG_COUNTERS}
    out = PM.run_bg(pm, lambda x, y: 2 * x + y[:, None], a, c)
    return out, {k: LOG.counters[k] - before[k] for k in BG_COUNTERS}


HOST = np.arange(48, dtype=np.int32).reshape(8, 2, 3)
WANT = 2 * torch.from_numpy(HOST) + torch.arange(
    16, dtype=torch.int32).reshape(8, 2, 1)


def test_run_bg_counts_an_array_callers_inputs_as_before():
    """A host array and a carry: the result is the whole computation, and
    the counters are one dispatch, 8 slot launches, each of the 7 slots
    past the gather slot receiving its carry part (2 x 4 B) and returning
    its result part (2 x 3 x 4 B), and the host array uploaded in 8 parts
    (upload.bytes = its bytes)."""
    out, got = _bg_call(HOST)
    assert torch.equal(out, WANT)
    assert got == {"mesh.dispatches": 1, "mesh.slot_launches": 8,
                   "mesh.exchange_bytes": 7 * (2 * 4 + 2 * 3 * 4),
                   "upload.bytes": HOST.nbytes, "upload.calls": 8}


def test_run_bg_slot_built_input():
    """A SlotBuilt in the host array's place: each slot builds its own
    part once, from its global (rows, cols) and on its device; the result
    equals the array caller's, the build is no exchange and, made here
    without to_device, no upload."""
    built = []

    def build(rows, cols, device):
        built.append((rows, cols, device))
        return torch.from_numpy(HOST[rows, cols]).to(device)

    out, got = _bg_call(PM.SlotBuilt(HOST.shape, build))
    assert torch.equal(out, WANT)
    _, pm = meshes(4, 2)
    assert built == [(*PM.bg_slots(pm, 8, 2)[s], CPU)
                     for s in pm.local_slots]
    assert got == {"mesh.dispatches": 1, "mesh.slot_launches": 8,
                   "mesh.exchange_bytes": 7 * (2 * 4 + 2 * 3 * 4),
                   "upload.bytes": 0, "upload.calls": 0}


def test_dryrun_multichip_on_cpu_slots():
    from jsplayer_tpu_torch.dryrun import dryrun_multichip

    dryrun_multichip(8, "cpu")

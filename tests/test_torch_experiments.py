"""The port's ds2 experiment path (jsplayer_tpu_torch.experiments, the
ds_probe twins and kmv_compose_ds2) against the Pallas experiment scripts
under scripts/, bit for bit, on the CPU.

Each script is loaded with importlib and shrunk through its Y/X/BH/T
globals to Y=40, X=256, BH=16 (40 = 2*16 + 8: the last block is partial
and reads 0 past Y in interpret mode).  Every Pallas kernel of the scripts
runs with ``interpret=True``, built as the script builds it, and is held
against the port's wrapper on CPU tensors (its plain twin).  The JAX
variants of exp_model_fusion2 run as jitted; E1/E2 are rebuilt here with an
interpret-mode ``_ds_kernel``, since the script's ds2_pallas has no
interpret flag.  u32 planes compare through int32 views, bf16 through
int16 views, tolerance 0.  Inputs come from numpy with fixed seeds."""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from jsplayer_tpu.kernels import rgb_convert as JR
from jsplayer_tpu.kernels import sp_recon as JS
from jsplayer_tpu_torch.experiments import exp_model_fusion2 as F
from jsplayer_tpu_torch.experiments import exp_pallas_bisect as PB
from jsplayer_tpu_torch.experiments import exp_pallas_ds as PD
from jsplayer_tpu_torch.experiments import exp_pallas_ds2 as PD2
from jsplayer_tpu_torch.experiments import probes
from jsplayer_tpu_torch.kernels import sp_recon as PS
from jsplayer_tpu_torch.kernels.ds_probe import ds_probe
from jsplayer_tpu_torch.kernels.rgb_convert import ds2_pack

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
Y, X, BH, T = 40, 256, 16, 2
NROWS = -(-Y // BH)


@functools.lru_cache(maxsize=None)
def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"_script_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def script(monkeypatch):
    """name → the script module with its globals shrunk to the small size."""
    monkeypatch.syspath_prepend(ROOT)

    def get(name):
        mod = _load(name)
        for k, v in dict(Y=Y, X=X, BH=BH, T=T).items():
            monkeypatch.setattr(mod, k, v)
        return mod
    return get


def frames_u32(shape, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)


def t32(a):
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def bits(x):
    """JAX array or torch tensor → a numpy array of comparable bits."""
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x)
    if a.dtype == jnp.bfloat16:
        return a.view(np.int16)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def interpret_call(kern, block, out_shape, frames):
    """A script's pallas_call: grid (C, ceil(Y/BH)), [1, BH, X] input
    blocks, `block`-shaped output blocks, in interpret mode."""
    return pl.pallas_call(
        kern, grid=(frames.shape[0], NROWS),
        in_specs=[pl.BlockSpec((1, BH, X), lambda t, i: (t, i, 0))],
        out_specs=pl.BlockSpec((1,) + block, lambda t, i: (t, i, 0)),
        out_shape=jax.ShapeDtypeStruct(out_shape, jnp.int32),
        interpret=True)(jnp.asarray(frames))


# ---------------------------------------------------------------------------
# Rows 5-7: the probe kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", PD.VARIANTS)
def test_ds_variant_matches_pallas(script, variant):
    """exp_pallas_ds: each variant's kernel against the port's route; all
    but `bitcast` equal rw22, and `bitcast` is pinned to the fold it
    computes (probes.bitcast_fold_ref)."""
    mod = script("exp_pallas_ds")
    f = frames_u32((T, Y, X), seed=5)
    want = np.asarray(interpret_call(
        functools.partial(mod._kernel, variant=variant), (BH // 2, X // 2),
        (T, Y // 2, X // 2), f))
    got = PD.ds2_pallas(t32(f), variant)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(PD.twin(variant)(t32(f)).numpy(), want)
    rw22 = np.asarray(jax.jit(mod.rw22)(jnp.asarray(f)))
    assert np.array_equal(want, rw22) == (variant != "bitcast")


#: the scripts' output blocks as functions of the (shrunk) BH and X
BLOCKS = {
    "passthru": lambda: (BH // 2, X // 2), "pack_h": lambda: (BH // 2, X // 2),
    "tpose16_notr": lambda: (BH // 4, X // 2),
    "sub_slice": lambda: (BH // 2, X), "sub_reshape": lambda: (BH // 2, X),
    "sub_roll": lambda: (BH // 2, X), "bitcast_h": lambda: (BH // 2, X),
    "minor_reshape": lambda: (BH, X // 2),
    "lane_gather_same": lambda: (BH, X // 2), "transpose": lambda: (X, BH),
}
PROBES = [("exp_pallas_ds2", n, PD2.CASES[n]) for n in PD2.CASES] + \
    [("exp_pallas_bisect", n, PB.CASES[n]) for n in PB.CASES]


@pytest.mark.parametrize("name,case,mode", PROBES)
def test_probe_matches_pallas(script, name, case, mode):
    """Each probe kernel of exp_pallas_ds2/exp_pallas_bisect against its
    ds_probe mode, padded block rows included."""
    mod = script(name)
    f = frames_u32((T, Y, X), seed=len(case))
    block = BLOCKS[case]()
    shape = (T, block[0] * NROWS, block[1])
    want = np.asarray(interpret_call(getattr(mod, f"k_{case}"), block,
                                     shape, f))
    got = ds_probe(t32(f), mode, BH)
    assert tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name,case,fn", [
    ("exp_pallas_ds2", "passthru", "torch_passthru"),
    ("exp_pallas_bisect", "transpose", "torch_block_transpose"),
    ("exp_pallas_bisect", "sub_slice", "torch_hpair_i32"),
    ("exp_pallas_bisect", "minor_reshape", "torch_wpair_i32")])
def test_library_call_matches_pallas(script, name, case, fn):
    """Each PyTorch call that chip_smoke.py times beside a ds_probe mode
    (its library_ms), on a Y that BH divides, against the script's Pallas
    kernel (the int32 pair sums wrap in both)."""
    from jsplayer_tpu_torch.experiments import probe_step

    mod = script(name)
    f = frames_u32((T, NROWS * BH, X), seed=17)
    block = BLOCKS[case]()
    want = np.asarray(interpret_call(getattr(mod, f"k_{case}"), block,
                                     (T, block[0] * NROWS, block[1]), f))
    got = getattr(probe_step, fn)(t32(f), BH)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name,case,mode", PROBES)
def test_probe_shapes_match_scripts_at_full_size(name, case, mode):
    """probes.probe_shape at the scripts' own sizes (1080p, BH=128, T=64
    and T=4) equals the out_shape each script gives pallas_call."""
    mod = _load(name)
    oshape = mod.CASES[case][1]
    nrows = -(-mod.Y // mod.BH)
    want = (mod.T, oshape[0] * nrows, oshape[1])
    assert probes.probe_shape(mode, mod.T, mod.Y, mod.X, mod.BH) == want


def test_probe_experiments_run_on_cpu():
    """The entry points' run(): every case bit-exact against its twin, and
    exactly the bitcast variant differs from rw22."""
    f = t32(frames_u32((T, Y, X), seed=3))
    ds = PD.run(f)
    assert all(r["parity"] for r in ds.values())
    assert {v: r["equals_rw22"] for v, r in ds.items()} == \
        {v: v != "bitcast" for v in PD.VARIANTS}
    for res in (PD2.run(f, bh=BH), PB.run(f, bh=BH)):
        assert all(r["parity"] and r["ms"] is None for r in res.values())


@pytest.mark.parametrize("mode", sorted(probes.MODES))
def test_ds_probe_cpu_out_and_guards(mode):
    """On the CPU the wrapper writes the twin into a given out; it refuses a
    BH that is not a multiple of 4 and an unknown mode."""
    f = t32(frames_u32((2, 18, 20), seed=9))
    want = probes.probe_ref(f, mode, 8)
    out = torch.full(want.shape, -1, dtype=torch.int32)
    assert ds_probe(f, mode, 8, out=out) is out
    np.testing.assert_array_equal(out.numpy(), want.numpy())
    with pytest.raises(ValueError, match="multiple of 4"):
        ds_probe(f, mode, 6)
    with pytest.raises(ValueError, match="unknown mode"):
        ds_probe(f, mode + "_x")


@pytest.mark.parametrize("mode,C,Yp,Xp", [
    (mode, *shape) for mode in sorted(probes.MODES)
    for shape in ((1, 20, 16), (2, 13, 10), (1, 9, 11))
    if not (mode == "bitcast_fold" and shape[2] % 2)])  # it needs even X
def test_probe_read_words_counts_dependencies(mode, C, Yp, Xp):
    """probe_read_words (the input side of chip_smoke.py's bound) is the
    number of input words the twin's output depends on: flipping bit 0 of
    a word, which every mode reads, changes the output exactly there."""
    f = t32(frames_u32((C, Yp, Xp), seed=C + Yp))
    base = probes.probe_ref(f, mode, 8)
    flat = f.reshape(-1)
    n = 0
    for i in range(flat.numel()):
        g = flat.clone()
        g[i] ^= 1
        n += not torch.equal(probes.probe_ref(g.reshape(f.shape), mode, 8),
                             base)
    assert probes.probe_read_words(mode, C, Yp, Xp, 8) == n


@pytest.fixture
def smoke(monkeypatch):
    """chip_smoke.py as a module (its byte counts run on the CPU)."""
    monkeypatch.syspath_prepend(ROOT)
    return importlib.import_module("chip_smoke")


def test_kmv_bytes_counts_what_each_pixel_reads(smoke):
    """chip_smoke.py's kmv bound: out for every pixel; an unchanged stream
    reads prev; a changed one reads paycode, and prev besides where the
    word is not data (ptype != 1)."""
    pc = torch.tensor([[[1 << 24, 0], [2 << 24, 3 << 24]],
                       [[1 << 24, 1 << 24], [1 << 24, 0]]], dtype=torch.int32)
    mvk = torch.zeros((2, 2, 2), dtype=torch.int32)
    chg = torch.tensor([True, False])
    red = torch.zeros((2, 1, 1), dtype=torch.int32)
    words = (4 + 4 + 3) + (4 + 4)  # stream 0 has one data pixel
    assert smoke.kmv_bytes(pc, mvk, chg) == 4 * words + 32 + 2
    assert smoke.kmv_bytes(pc, mvk, chg, red) == 4 * words + 32 + 2 + 8


def test_payload_bytes_count_the_named_tiles(smoke):
    """chip_smoke.py's unpack_payload bound: every word of [T, Y, X]
    written, the tile_block rows read, and one 1 KB tile a named block;
    pads and indices outside [0, NB) read no tile."""
    tb = torch.tensor([[0, 3, -1, 7], [8, 2, 2, -5]], dtype=torch.int32)
    out = 4 * 2 * 32 * 64
    assert smoke.payload_bytes(tb, 8, 32, 64) == out + 32 + 1024 * 5
    assert smoke.payload_bytes(tb[0], 8, 32, 64) == out // 2 + 16 + 1024 * 3


def test_msv1_bytes_count_the_painted_blocks():
    """experiments/msv1_step's bound: init read and every frame written
    once, btype read, 16 bytes of sel and 32 of colours a painted block, 4
    bytes of diff a step; at the sector grain, each painted block's sel
    rows as the 32-byte sectors they lie in (8 blocks a sector row) and
    btype as whole sectors."""
    from jsplayer_tpu_torch.experiments.msv1_step import (msv1_bytes,
                                                          msv1_sector_bytes)

    init = torch.zeros((1, 4, 64), dtype=torch.int32)
    frames = torch.zeros((1, 2, 4, 64), dtype=torch.int32)
    bt = torch.zeros((1, 2, 16), dtype=torch.uint8)
    bt[0, 0, 0], bt[0, 0, 9], bt[0, 1, 3] = 1, 2, 1  # sector rows 0, 1; 0
    assert msv1_bytes(init, bt, frames) == 1024 + 32 + 2048 + 48 * 3 + 8
    assert msv1_sector_bytes(init, bt, frames) == (
        1024 + 2048 + 32 * 2 + 4 * 32 * 3 + 32 * 3 + 8)


def test_sparse_bytes_count_one_source_word_a_pixel():
    """experiments/sparse_step's bound: out written and one source word
    read a pixel for every stream, and the commands of the changed streams
    only (bcode, mvk, tile_idx, tile_yx), and changed."""
    from jsplayer_tpu_torch.experiments.sparse_step import sparse_bytes

    i32 = dict(dtype=torch.int32)
    prev = torch.zeros((2, 16, 32), **i32)
    args = [torch.zeros((2, 2), dtype=torch.uint8),
            torch.zeros((2, 2, 2), **i32), torch.zeros((3, 256), **i32),
            torch.zeros((2, 4), **i32), torch.zeros((2, 4, 2), **i32)]
    chg = torch.tensor([True, False])
    assert sparse_bytes(prev, args, chg) == 8 * 1024 + (2 + 16 + 16 + 32) + 2


@pytest.mark.parametrize("name", ["sp_compose_general", "sp_motion_patch",
                                  "sp_motion_mxu"])
def test_block_bytes_counts_one_source_word_a_pixel(smoke, name):
    """chip_smoke.py's sp_motion.cu bound: out and one source word a pixel;
    the mxu mode also prev where a still block's paycode word is a copy."""
    prev = torch.zeros((2, 32, 32), dtype=torch.int32)
    chg = torch.tensor([True, False])  # stream 1 copies prev
    if name == "sp_motion_mxu":
        paycode = torch.zeros_like(prev)
        paycode[:, :16] = 1 << 24  # the top row of blocks is data
        is_motion = torch.tensor([[1, 0, 0, 0]] * 2, dtype=torch.int32)
        args = (paycode, torch.zeros((2, 4, 2), dtype=torch.int32), is_motion)
        cmds = 64 + 32
        extra = 512  # stream 0's two copy blocks read paycode and prev
    else:
        args = (torch.zeros((2, 4), dtype=torch.int32),
                torch.zeros((2, 4, 2), dtype=torch.int32),
                torch.zeros((2, 4, 4), dtype=torch.int32), prev)
        cmds, extra = 32 + 64 + 128, 0
    assert smoke.block_bytes(name, prev, args, chg) == \
        4 * (2 * prev.numel() + extra) + cmds + 2


# ---------------------------------------------------------------------------
# Row 4: the in-scan ds2 and exp_model_fusion2's variants
# ---------------------------------------------------------------------------

def ds2_interpret(mod, frames):
    """The script's ds2_pallas with interpret=True: [C, Y, X] → [C, Y/2,
    X/2] through _ds_kernel."""
    return interpret_call(mod._ds_kernel, (BH // 2, X // 2),
                          (frames.shape[0], Y // 2, X // 2), frames)


def test_ds_kernel_matches_pallas(script):
    """exp_model_fusion2's _ds_kernel against the three routes of the port
    that compute it: the fused step's ds2 plane (on a step where every
    pixel copies prev), ds2_pack without flip (E2) and ds2_fields."""
    mod = script("exp_model_fusion2")
    f = frames_u32((3, Y, X), seed=4)
    want = np.asarray(ds2_interpret(mod, jnp.asarray(f)))
    still = (t32(f), torch.zeros((3, Y, X), dtype=torch.int32),
             torch.zeros((3, 2, 2), dtype=torch.int32),
             torch.ones(3, dtype=torch.bool))
    out, red = PS.kmv_compose_ds2(*still)
    np.testing.assert_array_equal(out.numpy(), f.view(np.int32))
    np.testing.assert_array_equal(red.numpy(), want)
    np.testing.assert_array_equal(ds2_pack(t32(f)).numpy(), want)
    np.testing.assert_array_equal(ds_probe(t32(f), "ds2_fields").numpy(),
                                  want)


def kmv_transport(Tc, K=2, seed=0, Yk=Y, Xk=X, mv_range=300):
    """Random compacted kmv transport: every ptype (3 = copy too) and kslot
    (>= K never matches), vectors that wrap and leave the frame."""
    rng = np.random.default_rng(seed)
    init = rng.integers(0, 1 << 24, (Yk, Xk)).astype(np.uint32)
    word = (rng.integers(0, 1 << 24, (Tc, Yk, Xk)).astype(np.uint32)
            | (rng.integers(0, 4, (Tc, Yk, Xk)).astype(np.uint32) << 24)
            | (rng.integers(0, 8, (Tc, Yk, Xk)).astype(np.uint32) << 26))
    mvk = rng.integers(-mv_range, mv_range, (Tc, K, 2)).astype(np.int32)
    return init, word, mvk


@pytest.mark.parametrize("B,Yk,Xk", [(2, 40, 256), (3, 33, 71), (2, 7, 9),
                                     (1, 1, 5)])
def test_kmv_compose_ds2_twin(B, Yk, Xk):
    """The fused step's twin against the reference step (compose_frame_kmv
    under changed, as _scan_decode_kmv) and ds2_pack_ref of its output;
    odd sizes drop the last row/column from the ds2 plane."""
    rng = np.random.default_rng(B + Yk)
    prev = frames_u32((B, Yk, Xk), seed=Yk)
    _, word, mvk = kmv_transport(B, seed=Xk, Yk=Yk, Xk=Xk)
    chg = rng.random(B) < 0.7
    chg[0] = True
    out, red = PS.kmv_compose_ds2(t32(prev), t32(word), t32(mvk),
                                  torch.from_numpy(chg))
    for b in range(B):
        want = jnp.where(bool(chg[b]), JS.compose_frame_kmv(
            jnp.asarray(prev[b]), jnp.asarray(word[b]), jnp.asarray(mvk[b])),
            jnp.asarray(prev[b]))
        np.testing.assert_array_equal(out[b].numpy(), bits(want))
        np.testing.assert_array_equal(red[b].numpy(),
                                      bits(JR.ds2_pack_ref(want)))


def jax_variants(mod, init, pc, mvk):
    """The script's seven variants in JAX on the CPU: A, A_nchw and
    Arw_nchw as its jitted functions; E1/E1_nchw/E1_packed/E2 rebuilt with
    the interpret-mode _ds_kernel."""
    def step(prev, inp):
        p, m = inp
        out = JS.compose_frame_kmv(prev, p, m)
        return out, ds2_interpret(mod, out[None])[0]

    red = jax.lax.scan(step, init, (pc, mvk))[1]
    frames = JS.decode_sequence_kmv_compact(init, pc, mvk)
    return {"A": mod.variant_A(init, pc, mvk),
            "A_nchw": mod.variant_A_nchw(init, pc, mvk),
            "Arw_nchw": mod.variant_Arw_nchw(init, pc, mvk),
            "E1": mod.unpack_small(red), "E1_nchw": mod.unpack_nchw(red),
            "E1_packed": red,
            "E2": mod.unpack_small(ds2_interpret(mod, frames))}


@pytest.fixture
def fusion_case(script):
    """(JAX variants, port inputs) on one random compacted transport."""
    init, pc, mvk = kmv_transport(5, seed=11)
    want = jax_variants(script("exp_model_fusion2"), jnp.asarray(init),
                        jnp.asarray(pc), jnp.asarray(mvk))
    return want, (t32(init), t32(pc), t32(mvk))


def test_fusion_variants_match_jax(fusion_case):
    """Each of the port's seven variants equals the script's, bit for bit
    (bf16 through int16 views)."""
    want, args = fusion_case
    assert set(want) == set(F.VARIANTS)
    for name, (fn, _) in F.VARIANTS.items():
        got = fn(*args)
        assert tuple(got.shape) == tuple(want[name].shape), name
        np.testing.assert_array_equal(bits(got), bits(want[name]),
                                      err_msg=name)


@pytest.mark.parametrize("name", ["unpack_small", "unpack_nchw"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_unpack_matches_script(script, name, dtype):
    mod = script("exp_model_fusion2")
    red = np.array(JR.ds2_pack_ref(jnp.asarray(frames_u32((3, 14, 22)))))
    red[0, 0, :4] = [-1, 2**31 - 1, -2**31, 1 << 30]  # every field bit set
    want = getattr(mod, name)(jnp.asarray(red), dtype=getattr(jnp, dtype))
    got = getattr(F, name)(torch.from_numpy(red), dtype=getattr(torch, dtype))
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(bits(got), bits(want))


def test_fusion_run_reports_parity(fusion_case):
    """run(): every variant against A, no times on the CPU."""
    res = F.run(*fusion_case[1])
    assert set(res) == set(F.VARIANTS)
    assert all(r["parity"] and r["fps"] is None for r in res.values())


# ---------------------------------------------------------------------------
# The bench-mix stream and the slice as a whole
# ---------------------------------------------------------------------------

SY, SX, ST = 160, 256, 8


@pytest.fixture
def native_lib():
    from jsplayer_tpu import native

    if not native.available():
        pytest.skip("native library unavailable")


def test_bench_mix_stream_matches_bench(native_lib, monkeypatch):
    """streams.py against bench.real_stream_commands (its disk cache
    bypassed): the same encoded frames and the same compacted kmv
    transport."""
    import bench
    from jsplayer_tpu_torch.experiments import streams

    for k, v in dict(Y=SY, X=SX, T=ST).items():
        monkeypatch.setattr(bench, k, v)
    monkeypatch.setattr(bench, "cached_streams", lambda key, build: build())
    real = bench.real_stream_commands()
    got, kmv, st = real[0], real[1], real[5]
    assert streams.bench_mix_stream(SY, SX, ST) == st
    want = JS.compact_changed(kmv["paycode"][0], kmv["mvk"][0],
                              got["changed"][0])
    port = streams.bench_mix_kmv(SY, SX, ST)
    assert 0 < len(port[0]) < ST  # stills were elided
    for a, b in zip(port, want):
        np.testing.assert_array_equal(a, b)


def test_slice_on_bench_mix_stream(native_lib, script):
    """The whole path: the bench-mix stream decoded, compacted and run
    through all seven variants on the CPU, each equal to the script's A
    (and the port's A equal to it bit for bit)."""
    init, pc, mvk, n = F.load_stream("cpu", SY, SX, ST)
    assert tuple(pc.shape) == (n, SY, SX)
    res = F.run(init, pc, mvk, timeline_frames=ST)
    assert all(r["parity"] for r in res.values())
    mod = script("exp_model_fusion2")
    want = mod.variant_A(jnp.asarray(init.numpy().view(np.uint32)),
                         jnp.asarray(pc.numpy().view(np.uint32)),
                         jnp.asarray(mvk.numpy()))
    np.testing.assert_array_equal(bits(F.variant_A(init, pc, mvk)),
                                  bits(want))

"""The port stands without JAX and never falls back from the card: its
package imports no jax and nothing of jsplayer_tpu (it runs on its own
copies of the host stage), asking for CUDA where there is none raises, and
a kernel wrapper given a tensor that is not on the CPU launches or raises —
it never takes the plain version."""

import os
import re
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)

TINY_INGEST = r"""
import sys
import numpy as np
import jsplayer_tpu_torch as jt
from jsplayer_tpu_torch.encode.avi_mux import mux_avi
from jsplayer_tpu_torch.encode.sp_enc import ScreenPressorEncoder

enc = ScreenPressorEncoder(4, 32, 32)
f = np.full(32 * 32, 0x102030, dtype=np.uint32)
chunks = [enc.encode_i(f)]
for t in range(5):
    f = f.copy()
    f[t * 64:(t + 1) * 64] = 0x405060 + t
    chunks.append(enc.encode_p(f))
avi = mux_avi(chunks, 32, 32, 24, codec="SPV4",
              keyflags=[t == 0 for t in range(6)])
pipe = jt.VideoIngestPipeline(
    [jt.MemorySource(avi), jt.MemorySource(avi)],
    jt.IngestConfig(window=4, still_elision=True, model_downscale=2,
                    device="cpu"))
n = sum(int(np.asarray(b["outmap"]).size) for b in pipe)
assert n == 2 * 8, n
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
ref = [m for m in sys.modules if m.split(".")[0] == "jsplayer_tpu"]
assert not ref, sorted(ref)
print("ok", n)
"""


def test_port_runs_without_importing_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", TINY_INGEST], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok 16"


TINY_PALLAS = TINY_INGEST.split("pipe = ")[0] + r"""
pipe = jt.VideoIngestPipeline(
    [jt.MemorySource(avi), jt.MemorySource(avi)],
    jt.IngestConfig(window=4, sp_device_path="pallas", model_downscale=2,
                    device="cpu"))
frames = [w["frames_u32"] for w in pipe]
n = sum(f.shape[1] for f in frames)
assert [tuple(f.shape) for f in frames] == [(2, 4, 32, 32)] * 2, frames
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
ref = [m for m in sys.modules if m.split(".")[0] == "jsplayer_tpu"]
assert not ref, sorted(ref)
print("ok", n)
"""


def test_pallas_path_runs_without_importing_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", TINY_PALLAS], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok 8"


TINY_BC = TINY_INGEST.split("pipe = ")[0] + r"""
pipe = jt.VideoIngestPipeline(
    [jt.MemorySource(avi), jt.MemorySource(avi)],
    jt.IngestConfig(window=4, sp_device_path="bc", still_elision=True,
                    model_downscale=2, device="cpu"))
n = sum(int(np.asarray(b["outmap"]).size) for b in pipe)
from jsplayer_tpu_torch import validate
legs = validate.run("cpu")
assert legs == {leg: True for leg in validate.LEGS}, legs
from jsplayer_tpu_torch.pipeline.batch import stack_sp_commands
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
ref = [m for m in sys.modules if m.split(".")[0] == "jsplayer_tpu"]
assert not ref, sorted(ref)
print("ok", n, len(legs))
"""


def test_bc_path_and_validate_run_without_importing_jax():
    """The bc ingest path, jsplayer_tpu_torch.validate's legs and
    pipeline/batch.py import no jax and nothing of jsplayer_tpu."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", TINY_BC], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok 16 9"


TINY_LANE = TINY_INGEST.split("pipe = ")[0] + r"""
n = 0
for payload in ("raw", "rans"):
    lane = jt.transcode_to_lane(avi, window=4, K=2, payload=payload)
    for kw in (dict(sp_device_path="lane", still_elision=True),
               dict(model_downscale=2)):
        pipe = jt.VideoIngestPipeline(
            [jt.MemorySource(lane), jt.MemorySource(lane)],
            jt.IngestConfig(device="cpu", **kw))
        for w in pipe:
            om = w.get("outmap")
            n += om.size if om is not None else w["frames_u32"].shape[1]
from jsplayer_tpu_torch import validate
legs = validate.Legs("cpu")
res = {leg: getattr(legs, leg)() for leg in validate.LEGS if "lane" in leg}
assert res == {"lane_raw_parity": True, "lane_rans_parity": True,
               "lane_ragged_parity": True}, res
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
ref = [m for m in sys.modules if m.split(".")[0] == "jsplayer_tpu"]
assert not ref, sorted(ref)
print("ok", n, len(res))
"""


def test_lane_path_runs_without_importing_jax():
    """The lane ingest (raw and rans payloads, auto-detected and flagged,
    elided and dense), the port's transcode_to_lane and the three lane
    legs of jsplayer_tpu_torch.validate import no jax and nothing of
    jsplayer_tpu."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", TINY_LANE], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok 36 3"


TINY_SPARSE_MSV1 = TINY_INGEST.split("pipe = ")[0] + r"""
n = 0
for lane in (False, True):
    pipe = jt.VideoIngestPipeline(
        [jt.MemorySource(avi), jt.MemorySource(avi)],
        jt.IngestConfig(window=4, sp_device_path="kmv_sparse",
                        sparse_lane_payload=lane, model_downscale=2,
                        device="cpu"))
    n += sum(w["frames_u32"].shape[1] for w in pipe)
from jsplayer_tpu_torch.encode.msv1_enc import encode_frame_16
g = np.full(32 * 32, 0x102030, dtype=np.uint32)
chunks, prev = [], None
for t in range(5):
    g = g.copy()
    g[t * 64:(t + 1) * 64] = 0x080808 * (t + 1)
    chunks.append(encode_frame_16(g, prev, 32, 32))
    prev = g
msv1 = mux_avi(chunks, 32, 32, 16, codec="CRAM",
               keyflags=[t == 0 for t in range(5)])
pipe = jt.VideoIngestPipeline([jt.MemorySource(msv1)],
                              jt.IngestConfig(window=4, device="cpu"))
n += sum(w["frames_u32"].shape[1] for w in pipe)
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
ref = [m for m in sys.modules if m.split(".")[0] == "jsplayer_tpu"]
assert not ref, sorted(ref)
print("ok", n)
"""


def test_sparse_and_msv1_paths_run_without_importing_jax():
    """The kmv_sparse ingest (raw and rANS-coded tiles: kernels/
    lane_transport), the port's msv1_enc and the MSV1 ingest
    (kernels/msv1_paint) import no jax and nothing of jsplayer_tpu."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", TINY_SPARSE_MSV1], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok 24"


TINY_MESH = r"""
import sys
from jsplayer_tpu_torch.dryrun import dryrun_multichip
from jsplayer_tpu_torch.pipeline import mesh
dryrun_multichip(4, "cpu")
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
ref = [m for m in sys.modules if m.split(".")[0] == "jsplayer_tpu"]
assert not ref, sorted(ref)
print("ok", mesh.make_mesh(gop=2, devices=["cpu"] * 4).shape)
"""


def test_mesh_and_dryrun_run_without_importing_jax():
    """pipeline/mesh.py, the sharded steps and ingest routes the dry run
    drives, and dryrun.py import no jax and nothing of jsplayer_tpu."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", TINY_MESH], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok {'dp': 2, 'gop': 2}"


TINY_HOST = TINY_INGEST.split("pipe = ")[0] + r"""
import io
import json
import os
import tempfile
from contextlib import redirect_stdout

import torch

from jsplayer_tpu_torch import (ByteSource, CodecType, FileSource, Player,
                                PlayerConfig, VideoInfo, __version__,
                                transcode_sp)
from jsplayer_tpu_torch.__main__ import main
from jsplayer_tpu_torch.av import pcm
from jsplayer_tpu_torch.codecs import lane_host, native_sp
from jsplayer_tpu_torch.core import lane_loader
from jsplayer_tpu_torch.kernels import rgb_convert
from jsplayer_tpu_torch.native import ffshim
from jsplayer_tpu_torch.pipeline import checkpoint, manager
from jsplayer_tpu_torch import web

d = tempfile.mkdtemp()
src = os.path.join(d, "a.avi")
open(src, "wb").write(avi)
out = io.StringIO()
with redirect_stdout(out):
    for argv in (["info", src], ["play", src],
                 ["transcode", src, os.path.join(d, "b.avi"), "--jobs", "1"],
                 ["transcode", src, os.path.join(d, "c.jlv"), "--format",
                  "lane", "--window", "4", "--jobs", "1"],
                 ["render", src, os.path.join(d, "r"), "--wav", "--device",
                  "cpu"]):
        assert main(argv) == 0, argv
res = [json.loads("{" + t if not t.startswith("{") else t)
       for t in out.getvalue().strip().split("\n{")]
assert res[-1]["frames_written"] == 6, res[-1]
p = Player(PlayerConfig(indexed=False))
vi = p.load(src)
assert (vi.width, vi.codec) == (32, CodecType.SCREENPRESSOR)
emb = rgb_convert.packed_consumer_step(
    torch.zeros((2, 16, 16), dtype=torch.int32),
    torch.zeros((4, 4, 3, 8), dtype=torch.bfloat16))
assert tuple(emb.shape) == (2, 4, 4, 8)
assert transcode_sp(avi, target_version=3)[:4] == b"RIFF"
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
ref = [m for m in sys.modules if m.split(".")[0] == "jsplayer_tpu"]
assert not ref, sorted(ref)
print("ok", __version__, len(os.listdir(os.path.join(d, "r"))))
"""


def test_cli_player_and_web_run_without_importing_jax():
    """The CLI commands (info, play, transcode, render on the CPU), the
    public surface, the Player, Manager, web server, checkpoint, PCM, FFmpeg
    shim, lane host modules and rgb_convert's consumer import no jax and
    nothing of jsplayer_tpu."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", TINY_HOST], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "ok 0.2.0 6"


def port_sources():
    """chip_smoke.py and every .py file of the port's package."""
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "jsplayer_tpu_torch")):
        paths += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return paths


#: an import line of the JAX package (jsplayer_tpu_torch itself is fine)
REFERENCE_IMPORT = re.compile(r"^\s*(from|import)\s+jsplayer_tpu(\.|\s|$)",
                              re.M)


def offenders(pat):
    paths = port_sources()
    assert len(paths) > 30, paths
    return [p for p in paths if pat.search(open(p).read())]


def test_no_jax_import_lines():
    assert not offenders(re.compile(r"^\s*(import jax|from jax)", re.M))


def test_no_reference_import_lines():
    """The port runs on its own copies of the host stage: no line of it or
    of chip_smoke.py imports jsplayer_tpu."""
    assert not offenders(REFERENCE_IMPORT)


def test_reference_import_scan_catches_each_form():
    """The scan's pattern refuses every way of naming the JAX package and
    none of the port's."""
    pat = REFERENCE_IMPORT
    for line in ("import jsplayer_tpu", "from jsplayer_tpu import native",
                 "    from jsplayer_tpu.core.source import MemorySource",
                 "import jsplayer_tpu.native as n"):
        assert pat.search(line), line
    for line in ("import jsplayer_tpu_torch",
                 "from jsplayer_tpu_torch.native import load",
                 "    from .. import native", "# from jsplayer_tpu import x"):
        assert not pat.search(line), line


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the no-card path")


def test_cuda_config_raises_without_a_card(no_cuda):
    from jsplayer_tpu_torch import IngestConfig
    from jsplayer_tpu_torch.device import resolve_device

    with pytest.raises(RuntimeError, match="cuda"):
        IngestConfig(device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        IngestConfig()  # the default device is the card
    with pytest.raises(RuntimeError):
        resolve_device("cuda:0")
    assert resolve_device("cpu").type == "cpu"


def test_non_cpu_tensors_never_take_the_plain_path(no_cuda):
    """A tensor off the CPU goes to the kernel branch, which raises here
    (no card): nothing falls back to the plain twin."""
    from jsplayer_tpu_torch.kernels.rgb_convert import ds2_pack
    from jsplayer_tpu_torch.kernels.sp_recon import kmv_compose

    meta = dict(dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ds2_pack(torch.empty((2, 8, 8), **meta))
    with pytest.raises(ValueError, match="CUDA"):
        kmv_compose(torch.empty((1, 8, 8), **meta),
                    torch.empty((1, 8, 8), **meta),
                    torch.empty((1, 2, 2), **meta),
                    torch.ones(1, dtype=torch.bool, device="meta"))
    assert ds2_pack.launches == 0 and kmv_compose.launches == 0


def test_kernel_build_raises_without_nvcc(no_cuda, monkeypatch, tmp_path):
    from jsplayer_tpu_torch import _build

    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    monkeypatch.setattr(_build, "LIB_PATH", str(tmp_path / "missing.so"))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load()


def test_block_kernels_never_take_the_plain_path(no_cuda):
    """The three wrappers of csrc/sp_motion.cu: a tensor off the CPU goes to
    the kernel branch, which raises here (no card)."""
    from jsplayer_tpu_torch.kernels.sp_motion_mxu import sp_motion_mxu
    from jsplayer_tpu_torch.kernels.sp_motion_pallas import sp_motion_patch
    from jsplayer_tpu_torch.kernels.sp_recon import sp_compose_general

    meta = dict(dtype=torch.int32, device="meta")
    plane = torch.empty((1, 16, 16), **meta)
    chg = torch.ones(1, dtype=torch.bool, device="meta")
    bts, mv, rect = (torch.empty((1, 1) + s, **meta)
                     for s in ((), (2,), (4,)))
    for step in (sp_compose_general, sp_motion_patch):
        with pytest.raises(ValueError, match="CUDA"):
            step(plane, bts, mv, rect, plane, chg)
    with pytest.raises(ValueError, match="CUDA"):
        sp_motion_mxu(plane, plane, mv, bts, chg)
    assert sp_compose_general.launches == sp_motion_patch.launches == \
        sp_motion_mxu.launches == 0


def test_bc_kernel_never_takes_the_plain_path(no_cuda):
    """bc_compose: a tensor off the CPU goes to the kernel branch, which
    raises here (no card)."""
    from jsplayer_tpu_torch.kernels.sp_recon import bc_compose

    plane = torch.empty((1, 16, 16), dtype=torch.int32, device="meta")
    u8 = dict(dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        bc_compose(plane, plane, torch.empty((1, 1), **u8),
                   torch.empty((1, 1, 4), **u8),
                   torch.empty((1, 2, 2), dtype=torch.int32, device="meta"),
                   torch.ones(1, dtype=torch.bool, device="meta"))
    assert bc_compose.launches == 0


TINY_EXPERIMENTS = r"""
import importlib, pkgutil, sys
import torch
import jsplayer_tpu_torch.experiments as E
names = sorted(m.name for m in pkgutil.iter_modules(E.__path__))
for n in names:
    importlib.import_module(f"jsplayer_tpu_torch.experiments.{n}")
from jsplayer_tpu_torch.experiments import exp_pallas_bisect, exp_pallas_ds
from jsplayer_tpu_torch.experiments.common import rand_frames
from jsplayer_tpu_torch.kernels.sp_recon import kmv_compose_ds2
f = rand_frames((2, 20, 16), "cpu")
assert all(r["parity"] for r in exp_pallas_ds.run(f).values())
assert all(r["parity"] for r in exp_pallas_bisect.run(f, bh=8).values())
z = torch.zeros((2, 2, 2), dtype=torch.int32)
out, red = kmv_compose_ds2(f, f, z, torch.ones(2, dtype=torch.bool))
assert red.shape == (2, 10, 8)
from jsplayer_tpu_torch.experiments.kmv_step import ds2_inputs
out, red = kmv_compose_ds2(*ds2_inputs((3, 21, 17), 1, "cpu"))
assert out.shape == (3, 21, 17) and red.shape == (3, 10, 8)
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
ref = [m for m in sys.modules if m.split(".")[0] == "jsplayer_tpu"]
assert not ref, sorted(ref)
print("ok", " ".join(names))
"""


def test_experiments_run_without_importing_jax():
    """Every module of jsplayer_tpu_torch.experiments and kernels.ds_probe
    imports, and the probe twins and the fused step run, without jax."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", TINY_EXPERIMENTS], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == [
        "ok", "bc_step", "block_step", "common", "consumer_step",
        "exp_model_fusion2",
        "exp_pallas_bisect", "exp_pallas_ds", "exp_pallas_ds2", "kmv_step",
        "lane_runs", "lane_step", "msv1_step", "probe_step", "probes",
        "sparse_step", "streams"]


def test_experiment_kernels_never_take_the_plain_path(no_cuda):
    """ds_probe and kmv_compose_ds2: a tensor off the CPU goes to the kernel
    branch, which raises here (no card)."""
    from jsplayer_tpu_torch.kernels.ds_probe import ds_probe
    from jsplayer_tpu_torch.kernels.sp_recon import kmv_compose_ds2

    meta = dict(dtype=torch.int32, device="meta")
    plane = torch.empty((2, 16, 16), **meta)
    for mode in ("ds2_fields", "block_transpose"):
        with pytest.raises(ValueError, match="CUDA"):
            ds_probe(plane, mode, 8)
    with pytest.raises(ValueError, match="CUDA"):
        kmv_compose_ds2(plane, plane, torch.empty((2, 2, 2), **meta),
                        torch.ones(2, dtype=torch.bool, device="meta"))
    assert ds_probe.launches == kmv_compose_ds2.launches == 0


def test_lane_kernels_never_take_the_plain_path(no_cuda):
    """lane_compose, rans_decode_aligned and rans_decode_packed: a tensor
    off the CPU goes to the kernel branch, which raises here (no card)."""
    from jsplayer_tpu_torch.kernels.lane_recon import lane_compose
    from jsplayer_tpu_torch.kernels.rans_lanes import (rans_decode_aligned,
                                                       rans_decode_packed)

    i32 = dict(dtype=torch.int32, device="meta")
    u8 = dict(dtype=torch.uint8, device="meta")
    plane = torch.empty((1, 16, 16), **i32)
    with pytest.raises(ValueError, match="CUDA"):
        lane_compose(plane, torch.empty((1, 2, 16), **i32),
                     torch.empty((1, 16), **i32), torch.empty((1, 1), **u8),
                     torch.empty((1, 1, 4), **u8),
                     torch.empty((1, 2, 2), **i32),
                     torch.ones(1, dtype=torch.bool, device="meta"))
    states, freq = torch.empty((1, 8), **i32), torch.empty((1, 256), **i32)
    with pytest.raises(ValueError, match="CUDA"):
        rans_decode_aligned(torch.empty((1, 3, 8, 2), **u8), states, freq)
    with pytest.raises(ValueError, match="CUDA"):
        rans_decode_packed(torch.empty((1, 8, 4), **u8), states, freq, 3)
    assert lane_compose.launches == rans_decode_aligned.launches == \
        rans_decode_packed.launches == 0


def test_sparse_and_msv1_kernels_never_take_the_plain_path(no_cuda):
    """kmv_sparse_compose and msv1_paint: a tensor off the CPU goes to the
    kernel branch, which raises here (no card)."""
    from jsplayer_tpu_torch.kernels.msv1_paint import msv1_paint
    from jsplayer_tpu_torch.kernels.sp_recon import kmv_sparse_compose

    i32 = dict(dtype=torch.int32, device="meta")
    u8 = dict(dtype=torch.uint8, device="meta")
    plane = torch.empty((1, 16, 16), **i32)
    with pytest.raises(ValueError, match="CUDA"):
        kmv_sparse_compose(plane, torch.empty((1, 1), **u8),
                           torch.empty((1, 2, 2), **i32),
                           torch.empty((3, 256), **i32),
                           torch.empty((1, 2), **i32),
                           torch.empty((1, 2, 2), **i32),
                           torch.ones(1, dtype=torch.bool, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        msv1_paint(plane, torch.empty((1, 2, 16), **u8),
                   torch.empty((1, 2, 16, 16), **u8),
                   torch.empty((1, 2, 16, 8), **i32), 0)
    assert kmv_sparse_compose.launches == msv1_paint.launches == 0


TINY_LAST_FUNCTIONS = r"""
import sys
import numpy as np
import torch
from jsplayer_tpu_torch.kernels import msv1_paint, sparse_payload, sp_recon
from jsplayer_tpu_torch.pipeline import mesh

payload = np.arange(32 * 64, dtype=np.uint32).reshape(32, 64)
bts = np.array([1, 3, 0, 4, 2, 0, 0, 1], np.int32)
tiles, blocks = sparse_payload.pack_sequence(payload[None], bts[None], 6)
dense = sparse_payload.unpack_payload(
    torch.from_numpy(tiles.view(np.int32)), torch.from_numpy(blocks), 8, 32,
    64)
assert dense.shape == (1, 32, 64)
assert int((dense != 0).sum()) == 4 * 256 - 1, int((dense != 0).sum())
z = torch.zeros((8, 16, 16), dtype=torch.int32)
frames = sp_recon.decode_sequence_kmv_compact_unrolled(
    z[0], z, torch.zeros((8, 2, 2), dtype=torch.int32), unroll=4)
assert frames.shape == (8, 16, 16)
p = msv1_paint.paint_frame(z[0], torch.ones(16, dtype=torch.uint8),
                           torch.zeros((16, 16), dtype=torch.uint8),
                           torch.full((16, 8), 9, dtype=torch.int32))
assert bool((p == 9).all())
m = mesh.make_mesh(dp=2, gop=2, devices=["cpu"] * 4)
idx = mesh.stream_sharding(m).indices((4, 8))
assert idx[(1, 1)] == (slice(2, 4), slice(4, 8)), idx
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
ref = [m for m in sys.modules if m.split(".")[0] == "jsplayer_tpu"]
assert not ref, sorted(ref)
print("ok", sparse_payload.unpack_payload.launches,
      sp_recon.kmv_compose_frames.launches)
"""


def test_last_device_functions_run_without_importing_jax():
    """kernels/sparse_payload.py, the unrolled kmv scan, msv1_paint's
    paint_frame and the mesh's placement helpers import no jax and nothing
    of jsplayer_tpu (their CPU branches run no kernel)."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", TINY_LAST_FUNCTIONS],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok 0 0"


def test_scatter_and_frames_kernels_never_take_the_plain_path(no_cuda):
    """unpack_payload and kmv_compose_frames: a tensor off the CPU goes to
    the kernel branch, which raises here (no card)."""
    from jsplayer_tpu_torch.kernels.sp_recon import kmv_compose_frames
    from jsplayer_tpu_torch.kernels.sparse_payload import unpack_payload

    meta = dict(dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        unpack_payload(torch.empty((2, 256), **meta),
                       torch.empty(2, **meta), 4, 32, 32)
    with pytest.raises(ValueError, match="CUDA"):
        kmv_compose_frames(torch.empty((16, 16), **meta),
                           torch.empty((2, 16, 16), **meta),
                           torch.empty((2, 1, 2), **meta))
    assert unpack_payload.launches == kmv_compose_frames.launches == 0

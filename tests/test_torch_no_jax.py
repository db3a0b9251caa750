"""The port stands without JAX and never falls back from the card: its
package imports no jax, asking for CUDA where there is none raises, and a
kernel wrapper given a tensor that is not on the CPU launches or raises —
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
from jsplayer_tpu.encode.avi_mux import mux_avi
from jsplayer_tpu.encode.sp_enc import ScreenPressorEncoder

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
print("ok", n)
"""


def test_port_runs_without_importing_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", TINY_INGEST], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok 16"


def test_no_jax_import_lines():
    pat = re.compile(r"^\s*(import jax|from jax)", re.M)
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "jsplayer_tpu_torch")):
        paths += [os.path.join(d, n) for n in names if n.endswith(".py")]
    offenders = [p for p in paths if pat.search(open(p).read())]
    assert len(paths) > 5 and not offenders, offenders


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

"""Build and load the port's CUDA kernels.

The sources under ``csrc/`` have a plain C interface.  They are compiled at
first use with ``nvcc`` for ``sm_90a`` into one shared library under
``build/`` at the repository root, and loaded with ctypes: pointers go in
as ``c_void_p``, the stream as ``torch.cuda.current_stream().cuda_stream``.
The library is rebuilt when a source is newer than it.  A failed build
raises; nothing falls back to the plain versions.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build")
LIB_PATH = os.path.join(BUILD_DIR, "libjsptpu_torch_kernels.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: what the last build in this process did: {"seconds", "log", "cmd"}, or
#: None when the library was up to date and only loaded
last_build: Optional[dict] = None


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    t = os.path.getmtime(LIB_PATH)
    deps = _sources() + glob.glob(os.path.join(CSRC, "*.cuh"))
    return any(os.path.getmtime(p) > t for p in deps)


def find_nvcc() -> Optional[str]:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    return cand if os.path.exists(cand) else None


def build() -> str:
    """Compile csrc/*.cu into LIB_PATH unless it is up to date → the path.
    Raises RuntimeError when nvcc is missing or the compile fails."""
    global last_build
    if not _stale():
        return LIB_PATH
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH, /usr/local/cuda/bin): the port's CUDA "
            "kernels cannot be built")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *_sources()]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    dt = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed (rc {proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, LIB_PATH)  # atomic: a concurrent loader never sees half
    last_build = {"seconds": dt, "log": proc.stdout + proc.stderr,
                  "cmd": " ".join(cmd)}
    return LIB_PATH


def load() -> ctypes.CDLL:
    """Build if needed, load once per process, declare every signature."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.jsp_kmv_compose.restype = i32
        lib.jsp_kmv_compose.argtypes = [p, i64, p, i64, p, i64, p, i64, p, i64,
                                        i32, i32, i32, i32, p]
        lib.jsp_ds2_pack.restype = i32
        lib.jsp_ds2_pack.argtypes = [p, i64, p, i64, i32, i32, i32, i32, p]
        lib.jsp_error_string.restype = ctypes.c_char_p
        lib.jsp_error_string.argtypes = [i32]
        _lib = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise on a launch's cudaGetLastError() code."""
    if rc != 0:
        msg = _lib.jsp_error_string(rc).decode() if _lib is not None else "?"
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")

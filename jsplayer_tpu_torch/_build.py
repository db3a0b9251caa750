"""Build and load the port's CUDA kernels.

The sources under ``csrc/`` have a plain C interface.  They are compiled at
first use with ``nvcc`` for ``sm_90a``, one process per source, all
started together, then linked into one shared library under ``build/`` at
the repository root, and loaded with ctypes: pointers go in
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
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: what the last build in this process did: {"seconds", "log"}, or None
#: when the library was up to date and only loaded
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
    tag = f"{os.getpid()}.tmp"
    t0 = time.perf_counter()
    jobs = []
    for src in _sources():
        obj = os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for cmd, _, proc in jobs:
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed (rc {proc.returncode}): "
                          f"{' '.join(cmd)}\n{out}")
    objs = [obj for _, obj, _ in jobs]
    tmp = f"{LIB_PATH}.{tag}"
    link = [nvcc, "-shared", "-o", tmp, *objs]
    if not failed:
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            failed.append(f"nvcc link failed (rc {proc.returncode}): "
                          f"{' '.join(link)}\n{proc.stdout}{proc.stderr}")
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    if failed:
        raise RuntimeError("\n".join(failed))
    dt = time.perf_counter() - t0
    os.replace(tmp, LIB_PATH)  # atomic: a concurrent loader never sees half
    last_build = {"seconds": dt, "log": "".join(logs)}
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
        lib.jsp_kmv_compose_ds2.restype = i32
        lib.jsp_kmv_compose_ds2.argtypes = [p, i64] * 6 + [i32, i32, i32, i32,
                                                            p]
        lib.jsp_kmv_compose_frames.restype = i32
        lib.jsp_kmv_compose_frames.argtypes = [
            p, p, i64, p, i64, p, i64, i32, i32, i32, i32, i32,
            ctypes.POINTER(i32), p]
        lib.jsp_unpack_payload.restype = i32
        lib.jsp_unpack_payload.argtypes = [p, i64, i64, p, i64, p, p, i32,
                                           i32, i32, i32, i32, p]
        lib.jsp_bc_compose.restype = i32
        lib.jsp_bc_compose.argtypes = [p, i64] * 7 + [i32, i32, i32, i32, p]
        lib.jsp_lane_compose.restype = i32
        lib.jsp_lane_compose.argtypes = ([p, i64, p, i64, i64, i32]
                                         + [p, i64] * 6
                                         + [i32, i32, i32, i32, p])
        lib.jsp_kmv_sparse_compose.restype = i32
        lib.jsp_kmv_sparse_compose.argtypes = ([p, i64] * 5 + [p, i64, i64]
                                               + [p, i64] * 2
                                               + [p, i32, i32, i32, i32, i32,
                                                  p])
        lib.jsp_msv1_paint_instance.restype = i32
        lib.jsp_msv1_paint_instance.argtypes = [p, i64] + [p, i64, i64] * 3
        lib.jsp_msv1_paint.restype = i32
        lib.jsp_msv1_paint.argtypes = ([p, i64] + [p, i64, i64] * 4
                                       + [p, i32, i32, i32, i32, i32, p])
        lib.jsp_rans_decode_aligned.restype = i32
        lib.jsp_rans_decode_aligned.argtypes = [p, i64] * 4 + [i32, i32, i32,
                                                               p]
        lib.jsp_rans_decode_packed.restype = i32
        lib.jsp_rans_decode_packed.argtypes = ([p, i64, i32] + [p, i64] * 3
                                               + [i32, i32, i32, p])
        lib.jsp_rans_aligned_instance.restype = i32
        lib.jsp_rans_aligned_instance.argtypes = [p, i64, i32]
        lib.jsp_rans_chain_probe.restype = i32
        lib.jsp_rans_chain_probe.argtypes = [p, i64] * 3 + [i32, i32, i32, p]
        lib.jsp_ds2_pack.restype = i32
        lib.jsp_ds2_pack.argtypes = [p, i64, p, i64, i32, i32, i32, i32, p]
        lib.jsp_ds_probe.restype = i32
        lib.jsp_ds_probe.argtypes = [i32, p, i64, p, i64] + [i32] * 6 + [p]
        lib.jsp_ds_probe_instance.restype = i32
        lib.jsp_ds_probe_instance.argtypes = [i32, p, i64, p, i64, i32, i32]
        for name in ("jsp_sp_compose_general", "jsp_sp_motion_patch"):
            fn = getattr(lib, name)
            fn.restype = i32
            fn.argtypes = [p, i64] * 7 + [i32, i32, i32, p]
        lib.jsp_sp_motion_mxu.restype = i32
        lib.jsp_sp_motion_mxu.argtypes = [p, i64] * 6 + [i32, i32, i32, p]
        lib.jsp_error_string.restype = ctypes.c_char_p
        lib.jsp_error_string.argtypes = [i32]
        _lib = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise on a launch's cudaGetLastError() code."""
    if rc != 0:
        msg = _lib.jsp_error_string(rc).decode() if _lib is not None else "?"
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")

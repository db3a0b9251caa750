"""ctypes binding of the frozen ScreenPressor encoder (spenc.cpp).

The library is built with g++ at first use into build/portbench/ at the
checkout's root and rebuilt when spenc.cpp is newer; the build goes
through a process-tagged temporary and an atomic rename, so processes
that build at once never load half a library.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "spenc.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "portbench")
LIB_PATH = os.path.join(BUILD_DIR, "libspenc.so")
CXXFLAGS = ["-O2", "-fPIC", "-shared", "-std=c++17", "-pthread"]

_lock = threading.Lock()
_lib = None


def load() -> ctypes.CDLL:
    """Build if needed, load once per process.  Raises when g++ fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if (not os.path.exists(LIB_PATH)
                or os.path.getmtime(LIB_PATH) < os.path.getmtime(_SRC)):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
            proc = subprocess.run(
                [os.environ.get("CXX", "g++"), *CXXFLAGS, "-o", tmp, _SRC],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed to build {LIB_PATH}:\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, LIB_PATH)
        lib = ctypes.CDLL(LIB_PATH)
        lib.spenc_create.restype = ctypes.c_void_p
        lib.spenc_create.argtypes = [ctypes.c_int] * 4
        lib.spenc_destroy.argtypes = [ctypes.c_void_p]
        lib.spenc_encode.restype = ctypes.c_long
        lib.spenc_encode.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_int]
        lib.spenc_data.restype = ctypes.c_void_p
        lib.spenc_data.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


class Encoder:
    """One ScreenPressor stream (version 2, 3 or 4): encode_i / encode_p
    take a frame of u32 pixels and return its bitstream."""

    KIND_AUTO, KIND_I = 0, 1

    def __init__(self, version: int, width: int, height: int, bpp: int = 24):
        self._lib = load()
        self._h = self._lib.spenc_create(version, width, height, bpp)

    def close(self) -> None:
        if self._h:
            self._lib.spenc_destroy(self._h)
            self._h = None

    def _encode(self, frame: np.ndarray, kind: int) -> bytes:
        f = np.ascontiguousarray(frame, dtype=np.uint32).reshape(-1)
        n = self._lib.spenc_encode(self._h, f.ctypes.data, kind)
        if n < 0:
            raise ValueError("unencodable symbol (v3 Cx6 interval overshoot)")
        return ctypes.string_at(self._lib.spenc_data(self._h), n)

    def encode_i(self, frame: np.ndarray) -> bytes:
        return self._encode(frame, self.KIND_I)

    def encode_p(self, frame: np.ndarray) -> bytes:
        return self._encode(frame, self.KIND_AUTO)

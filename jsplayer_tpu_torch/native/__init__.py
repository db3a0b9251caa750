"""ctypes bindings for the native host decoder (spdec.cpp).

The shared library is built on demand with g++ (the flags of the JAX
package's native Makefile) into ``build/libjsptpu_host.so`` at the
repository root, and rebuilt when spdec.cpp is newer;
``available()`` gates callers so pure-Python fallbacks keep working when no
toolchain is present.  ``load()`` is thread-safe.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

from .._build import BUILD_DIR

_DIR = os.path.dirname(os.path.abspath(__file__))
_LIB_PATH = os.path.join(BUILD_DIR, "libjsptpu_host.so")
_SRC_PATH = os.path.join(_DIR, "spdec.cpp")
CXXFLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-std=c++17",
            "-Wall", "-pthread"]

_lib: Optional[ctypes.CDLL] = None
_tried = False
_lock = threading.Lock()


def _build() -> bool:
    # a pid-tagged temporary, then an atomic rename: processes that build
    # at once never load half a library
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        subprocess.run([os.environ.get("CXX", "g++"), *CXXFLAGS, "-o", tmp,
                        _SRC_PATH], check=True, capture_output=True)
        os.replace(tmp, _LIB_PATH)
        return True
    except Exception:
        if os.path.exists(tmp):
            os.remove(tmp)
        return False


def load() -> Optional[ctypes.CDLL]:
    with _lock:  # a second caller waits for the first load, not None
        return _load_locked()


def _load_locked() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None:
        return _lib
    if _tried:
        return None
    _tried = True
    if not os.path.exists(_LIB_PATH) or (
            os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC_PATH)):
        if not _build():
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    lib.sp_create.restype = ctypes.c_void_p
    lib.sp_create.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.sp_destroy.argtypes = [ctypes.c_void_p]
    lib.sp_preinit.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.sp_is_key_frame.restype = ctypes.c_int
    lib.sp_is_key_frame.argtypes = [ctypes.c_char_p, ctypes.c_long]
    lib.sp_decompress.restype = ctypes.c_int
    lib.sp_decompress.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long, ctypes.c_int,
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.sp_prev_frame.restype = ctypes.POINTER(ctypes.c_uint32)
    lib.sp_prev_frame.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_int)]
    lib.sp_decompress_kmv.restype = ctypes.c_int
    lib.sp_decompress_kmv.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.sp_decompress_kmv2.restype = ctypes.c_int
    lib.sp_decompress_kmv2.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int), ctypes.c_void_p,
    ]
    lib.sp_decompress_kmv_sparse.restype = ctypes.c_int
    lib.sp_decompress_kmv_sparse.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.sp_decode_streams_kmv.restype = ctypes.c_int
    lib.sp_decode_streams_kmv.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_char_p,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p,
    ]
    lib.sp_decode_streams.restype = ctypes.c_int
    lib.sp_decode_streams.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_char_p,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ]
    lib.sp_decompress_bc.restype = ctypes.c_int
    lib.sp_decompress_bc.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
    ]
    lib.sp_decode_streams_bc.restype = ctypes.c_int
    lib.sp_decode_streams_bc.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_char_p,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ]
    lib.spenc_create.restype = ctypes.c_void_p
    lib.spenc_create.argtypes = [ctypes.c_int] * 4
    lib.spenc_destroy.argtypes = [ctypes.c_void_p]
    lib.spenc_encode.restype = ctypes.c_long
    lib.spenc_encode.argtypes = [
        ctypes.c_void_p,
        np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"), ctypes.c_int]
    lib.spenc_data.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.spenc_data.argtypes = [ctypes.c_void_p]
    lib.msv1_parse_commands.restype = ctypes.c_int
    lib.msv1_parse_commands.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    if hasattr(lib, "lane_compose_range"):  # absent in a stale .so
        lib.lane_compose_range.restype = ctypes.c_int
        lib.lane_compose_range.argtypes = [
            np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ]
    _lib = lib
    return lib


def available() -> bool:
    return load() is not None


class NativeScreenPressor:
    """Native twin of codecs.screenpressor.ScreenPressor (bit-exact)."""

    def __init__(self, width: int, height: int, bpp: int = 24):
        lib = load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._h = lib.sp_create(width, height, bpp)
        self.X, self.Y = width, height
        self.nbx = (width + 15) // 16
        self.nby = (height + 15) // 16

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.sp_destroy(self._h)
            self._h = None

    def preinit(self, insignificant_lines: int) -> None:
        self._lib.sp_preinit(self._h, insignificant_lines)

    def is_key_frame(self, data: bytes) -> bool:
        return bool(self._lib.sp_is_key_frame(data, len(data)))

    def decompress(self, data: bytes, is_key: bool, capture: bool = False,
                   copy: bool = True):
        """→ (frame u32[X*Y] | None-if-nochange-uses-prev, signif, cap dict).

        ``copy=False`` skips the output memcpy and returns a zero-copy view
        of the decoder's internal ping-pong buffer — valid until the next
        decompress() call (the buffer two calls later is reused)."""
        dst = np.zeros(self.X * self.Y, dtype=np.uint32) if copy else None
        dstp = dst.ctypes.data_as(ctypes.c_void_p) if copy else None
        signif = ctypes.c_int(0)
        nb = self.nbx * self.nby
        if capture:
            bts = np.zeros(nb, dtype=np.int32)
            mv = np.zeros((nb, 2), dtype=np.int32)
            rect = np.zeros((nb, 4), dtype=np.int32)
            bp = bts.ctypes.data_as(ctypes.c_void_p)
            mp = mv.ctypes.data_as(ctypes.c_void_p)
            rp = rect.ctypes.data_as(ctypes.c_void_p)
        else:
            bts = mv = rect = None
            bp = mp = rp = None
        r = self._lib.sp_decompress(self._h, data, len(data),
                                    1 if is_key else 0, dstp,
                                    ctypes.byref(signif), bp, mp, rp)
        cap = {"bts": bts, "mv": mv, "rect": rect,
               "changed": r == 0} if capture else None
        if r == -1:
            raise ValueError("invalid stream")
        if r != 0:
            return None, bool(signif.value), cap
        if copy:
            return dst, bool(signif.value), cap
        return self.latest_view(), bool(signif.value), cap

    def latest_view(self) -> np.ndarray:
        """Zero-copy view of the latest decoded frame."""
        has = ctypes.c_int(0)
        ptr = self._lib.sp_prev_frame(self._h, ctypes.byref(has))
        return np.ctypeslib.as_array(ptr, shape=(self.X * self.Y,))

    def decompress_kmv_sparse(self, data: bytes, is_key: bool,
                              bcode: np.ndarray, mvk: np.ndarray,
                              tiles: np.ndarray, tile_yx: np.ndarray,
                              K: int = 2):
        """Decode one frame straight into SPARSE kmv transport (per-block
        codes + K vectors + final-content tiles) — the PCIe-serving shape.
        → (changed, signif, m_used).  m_used == -1 signals overflow (or a
        keyframe): the frame is decoded, ship latest_view() dense instead.
        Native twin of kernels/sp_recon.prepare_kmv_sparse (per frame)."""
        m_cap = tiles.shape[0]
        assert tiles.dtype == np.uint32 and tiles.size == m_cap * 256
        assert bcode.dtype == np.uint8 and bcode.size == self.nbx * self.nby
        signif = ctypes.c_int(0)
        m_used = ctypes.c_int32(0)
        r = self._lib.sp_decompress_kmv_sparse(
            self._h, data, len(data), 1 if is_key else 0, K, m_cap,
            bcode.ctypes.data_as(ctypes.c_void_p),
            mvk.ctypes.data_as(ctypes.c_void_p),
            tiles.ctypes.data_as(ctypes.c_void_p),
            tile_yx.ctypes.data_as(ctypes.c_void_p),
            ctypes.byref(m_used), ctypes.byref(signif))
        if r == -1:
            raise ValueError("invalid stream")
        if r == -2:
            return True, bool(signif.value), -1
        return r == 0, bool(signif.value), int(m_used.value)

    def decompress_kmv(self, data: bytes, is_key: bool, paycode: np.ndarray,
                       mvk: np.ndarray, K: int = 2,
                       dirty: Optional[np.ndarray] = None):
        """Decode one frame straight into kmv device transport: paycode
        [Y,X] u32 (written only when the frame changes) and mvk [K,2] i32.
        → (changed, signif).  Native twin of kernels/sp_recon.prepare_kmv
        fused into the decode pass (the numpy version costs ~170 ms/frame
        at 1080p; this is free next to the decode).

        dirty: optional [1 + nbx*nby] i32 incremental-fill state for this
        paycode plane (start a ZEROED plane with dirty[0]=0); P-frames then
        write only changed blocks instead of the full plane — the fill was
        84% of the host stage at 1080p."""
        assert paycode.dtype == np.uint32 and paycode.size == self.X * self.Y
        assert mvk.dtype == np.int32 and mvk.size == K * 2
        signif = ctypes.c_int(0)
        if dirty is not None:
            assert (dirty.dtype == np.int32
                    and dirty.size >= 1 + self.nbx * self.nby)
            r = self._lib.sp_decompress_kmv2(
                self._h, data, len(data), 1 if is_key else 0, K,
                paycode.ctypes.data_as(ctypes.c_void_p),
                mvk.ctypes.data_as(ctypes.c_void_p), ctypes.byref(signif),
                dirty.ctypes.data_as(ctypes.c_void_p))
        else:
            r = self._lib.sp_decompress_kmv(
                self._h, data, len(data), 1 if is_key else 0, K,
                paycode.ctypes.data_as(ctypes.c_void_p),
                mvk.ctypes.data_as(ctypes.c_void_p), ctypes.byref(signif))
        if r == -1:
            raise ValueError("invalid stream")
        return r == 0, bool(signif.value)


    def decompress_bc(self, data: bytes, is_key: bool, plane: np.ndarray,
                      mvk: np.ndarray, bcode: np.ndarray, rloc: np.ndarray,
                      K: int = 2):
        """Decode one frame straight into the bc device transport: plane
        [Y,X] u32 (ONLY data-rect pixels written — other bytes are never
        read by the device compose, so no clears/dirty tracking), bcode
        [NB] u8, rloc [NB,4] u8 block-local rects, mvk [K,2] i32.
        → (changed, signif).  Native twin of kernels/sp_recon.prepare_bc
        fused into the decode pass; the host fill collapses to the data
        pixels themselves (no motion fills — VERDICT round-2 item 5)."""
        nb = self.nbx * self.nby
        assert plane.dtype == np.uint32 and plane.size == self.X * self.Y
        assert mvk.dtype == np.int32 and mvk.size == K * 2
        assert bcode.dtype == np.uint8 and bcode.size == nb
        assert rloc.dtype == np.uint8 and rloc.size == nb * 4
        signif = ctypes.c_int(0)
        r = self._lib.sp_decompress_bc(
            self._h, data, len(data), 1 if is_key else 0, K,
            plane.ctypes.data_as(ctypes.c_void_p),
            mvk.ctypes.data_as(ctypes.c_void_p),
            bcode.ctypes.data_as(ctypes.c_void_p),
            rloc.ctypes.data_as(ctypes.c_void_p), ctypes.byref(signif))
        if r == -1:
            raise ValueError("invalid stream")
        return r == 0, bool(signif.value)


def native_msv1_parse(src: bytes, X: int, Y: int,
                      pal: Optional[np.ndarray] = None):
    """Native twin of codecs.msvideo1.parse_commands."""
    lib = load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    nb = (X >> 2) * (Y >> 2)
    btype = np.zeros(nb, dtype=np.uint8)
    sel = np.zeros((nb, 16), dtype=np.uint8)
    colors = np.zeros((nb, 8), dtype=np.uint32)
    palp = (pal.astype(np.uint32).ctypes.data_as(ctypes.c_void_p)
            if pal is not None else None)
    changes = lib.msv1_parse_commands(
        src, len(src), X, Y, palp,
        btype.ctypes.data_as(ctypes.c_void_p),
        sel.ctypes.data_as(ctypes.c_void_p),
        colors.ctypes.data_as(ctypes.c_void_p),
    )
    return btype, sel, colors, bool(changes)


def native_sp_decode_streams(streams, width, height, bpp=24,
                             insignificant_lines=0, nthreads=0, out=None):
    """Parallel multi-stream SP decode → command stacks + payload planes.

    streams: list of lists of frame bytes (equal frame counts).
    → dict(bts [B,T,NB] i32, mv [B,T,NB,2], rect [B,T,NB,4],
           payload [B,T,Y,X] u32, changed [B,T] bool, signif [B,T] bool).

    out: a dict previously returned by this function — its arrays are
    reused (steady-state serving: fresh 100s-of-MB allocations pay one
    page fault per 4KB page inside the C writes, which measured ~25x the
    decode cost at 1080p x 64 frames).
    """
    import os as _os

    lib = load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    B = len(streams)
    T = len(streams[0])
    assert all(len(s) == T for s in streams)
    blob = bytearray()
    offsets = np.zeros(B * T, dtype=np.int64)
    lengths = np.zeros(B * T, dtype=np.int64)
    for b, frames in enumerate(streams):
        for t, fr in enumerate(frames):
            offsets[b * T + t] = len(blob)
            lengths[b * T + t] = len(fr)
            blob += fr
    nbx, nby = (width + 15) // 16, (height + 15) // 16
    nb = nbx * nby
    if out is not None and out["payload"].shape == (B, T, height, width):
        payload, bts, mv, rect = out["payload"], out["bts"], out["mv"], out["rect"]
        changed = np.zeros((B, T), dtype=np.uint8)
        signif = np.zeros((B, T), dtype=np.uint8)
    else:
        # np.zeros, NOT np.empty: calloc's zero-page mapping faults in far
        # cheaper than malloc'd pages on first write (measured 20x at 530MB
        # on this host); the arrays are reusable via `out` either way
        payload = np.zeros((B, T, height, width), dtype=np.uint32)
        bts = np.zeros((B, T, nb), dtype=np.int32)
        mv = np.zeros((B, T, nb, 2), dtype=np.int32)
        rect = np.zeros((B, T, nb, 4), dtype=np.int32)
        changed = np.zeros((B, T), dtype=np.uint8)
        signif = np.zeros((B, T), dtype=np.uint8)
    if nthreads <= 0:
        nthreads = min(B, _os.cpu_count() or 1)
    errors = lib.sp_decode_streams(
        B, T, width, height, bpp, bytes(blob), offsets, lengths,
        insignificant_lines,
        payload.ctypes.data_as(ctypes.c_void_p),
        bts.ctypes.data_as(ctypes.c_void_p),
        mv.ctypes.data_as(ctypes.c_void_p),
        rect.ctypes.data_as(ctypes.c_void_p),
        changed.ctypes.data_as(ctypes.c_void_p),
        signif.ctypes.data_as(ctypes.c_void_p),
        nthreads,
    )
    return dict(bts=bts, mv=mv, rect=rect, payload=payload,
                changed=changed.astype(bool), signif=signif.astype(bool),
                errors=errors)


def split_stream_gops(frames, width, height):
    """Split one stream into keyframe-delimited rows padded with empty
    frames (both codecs define empty as no-change) so a single long stream
    parallelizes across the thread pool like independent streams — a fresh
    decoder at a keyframe reproduces the continuous decode exactly.
    → (rows [G][Tmax], spans [(start, n_real)])."""
    lib = load()
    keys = [bool(lib.sp_is_key_frame(f, len(f))) for f in frames]
    from ..pipeline.gop import split_gops

    gops = split_gops(frames, keys)
    tmax = max(len(g[1]) for g in gops)
    rows = [list(g[1]) + [b""] * (tmax - len(g[1])) for g in gops]
    spans = [(g[0], len(g[1])) for g in gops]
    return rows, spans


def native_sp_decode_streams_kmv(streams, width, height, bpp=24,
                                 insignificant_lines=0, K=2, nthreads=0,
                                 out=None, gop_split=False):
    """Parallel multi-stream SP decode straight into kmv device transport.

    → dict(paycode [B,T,Y,X] u32 (undefined where changed is False),
           mvk [B,T,K,2] i32, changed [B,T] bool, signif [B,T] bool).
    Pass a previous result as `out` to reuse its arrays (page-fault cost,
    see native_sp_decode_streams).

    gop_split=True (single stream only): split the stream into keyframe-
    delimited rows so ONE long stream saturates the thread pool; outputs
    are re-flattened to the original frame order."""
    if gop_split:
        assert len(streams) == 1, "gop_split handles a single stream"
        rows, spans = split_stream_gops(streams[0], width, height)
        got = native_sp_decode_streams_kmv(
            rows, width, height, bpp, insignificant_lines, K, nthreads)
        T = len(streams[0])
        pay = np.empty((1, T, height, width), dtype=np.uint32)
        mvk_o = np.zeros((1, T, K, 2), dtype=np.int32)
        chg = np.zeros((1, T), dtype=bool)
        sig = np.zeros((1, T), dtype=bool)
        for g, (start, n) in enumerate(spans):
            pay[0, start:start + n] = got["paycode"][g, :n]
            mvk_o[0, start:start + n] = got["mvk"][g, :n]
            chg[0, start:start + n] = got["changed"][g, :n]
            sig[0, start:start + n] = got["signif"][g, :n]
        return dict(paycode=pay, mvk=mvk_o, changed=chg, signif=sig,
                    errors=got["errors"])
    import os as _os

    lib = load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    B = len(streams)
    T = len(streams[0])
    assert all(len(s) == T for s in streams)
    blob = bytearray()
    offsets = np.zeros(B * T, dtype=np.int64)
    lengths = np.zeros(B * T, dtype=np.int64)
    for b, frames in enumerate(streams):
        for t, fr in enumerate(frames):
            offsets[b * T + t] = len(blob)
            lengths[b * T + t] = len(fr)
            blob += fr
    nb1 = 1 + ((width + 15) // 16) * ((height + 15) // 16)
    if out is not None and out["paycode"].shape == (B, T, height, width) \
            and out["mvk"].shape[-2] == K and "dirty" in out \
            and out["dirty"].shape == (B * T, nb1):
        # buffer reuse: the dirty rows say what each plane already holds,
        # so P-frames only clear+write changed blocks (fill_paycode_p)
        paycode, mvk, dirty = out["paycode"], out["mvk"], out["dirty"]
    else:
        paycode = np.zeros((B, T, height, width), dtype=np.uint32)
        mvk = np.zeros((B, T, K, 2), dtype=np.int32)
        dirty = np.zeros((B * T, nb1), dtype=np.int32)
    changed = np.zeros((B, T), dtype=np.uint8)
    signif = np.zeros((B, T), dtype=np.uint8)
    if nthreads <= 0:
        nthreads = min(B, _os.cpu_count() or 1)
    errors = lib.sp_decode_streams_kmv(
        B, T, width, height, bpp, bytes(blob), offsets, lengths,
        insignificant_lines, K,
        paycode.ctypes.data_as(ctypes.c_void_p),
        mvk.ctypes.data_as(ctypes.c_void_p),
        changed.ctypes.data_as(ctypes.c_void_p),
        signif.ctypes.data_as(ctypes.c_void_p),
        nthreads,
        dirty.ctypes.data_as(ctypes.c_void_p),
    )
    return dict(paycode=paycode, mvk=mvk, changed=changed.astype(bool),
                signif=signif.astype(bool), dirty=dirty, errors=errors)


def native_sp_decode_streams_bc(streams, width, height, bpp=24,
                                insignificant_lines=0, K=2, nthreads=0,
                                out=None):
    """Parallel multi-stream SP decode straight into the bc transport.

    → dict(plane [B,T,Y,X] u32 (ONLY data-rect pixels defined),
           bcode [B,T,NB] u8, rloc [B,T,NB,4] u8, mvk [B,T,K,2] i32,
           changed [B,T] bool, signif [B,T] bool).
    Unlike the kmv paycode there is NO dirty state: non-data plane bytes
    are never read, so buffer reuse via `out` is a pure allocation saving
    (no clears on any path)."""
    import os as _os

    lib = load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    B = len(streams)
    T = len(streams[0])
    assert all(len(s) == T for s in streams)
    blob = bytearray()
    offsets = np.zeros(B * T, dtype=np.int64)
    lengths = np.zeros(B * T, dtype=np.int64)
    for b, frames in enumerate(streams):
        for t, fr in enumerate(frames):
            offsets[b * T + t] = len(blob)
            lengths[b * T + t] = len(fr)
            blob += fr
    nb = ((width + 15) // 16) * ((height + 15) // 16)
    if out is not None and out["plane"].shape == (B, T, height, width) \
            and out["mvk"].shape[-2] == K:
        plane, mvk = out["plane"], out["mvk"]
        bcode, rloc = out["bcode"], out["rloc"]
    else:
        plane = np.zeros((B, T, height, width), dtype=np.uint32)
        mvk = np.zeros((B, T, K, 2), dtype=np.int32)
        bcode = np.zeros((B, T, nb), dtype=np.uint8)
        rloc = np.zeros((B, T, nb, 4), dtype=np.uint8)
    changed = np.zeros((B, T), dtype=np.uint8)
    signif = np.zeros((B, T), dtype=np.uint8)
    if nthreads <= 0:
        nthreads = min(B, _os.cpu_count() or 1)
    errors = lib.sp_decode_streams_bc(
        B, T, width, height, bpp, bytes(blob), offsets, lengths,
        insignificant_lines, K,
        plane.ctypes.data_as(ctypes.c_void_p),
        mvk.ctypes.data_as(ctypes.c_void_p),
        bcode.ctypes.data_as(ctypes.c_void_p),
        rloc.ctypes.data_as(ctypes.c_void_p),
        changed.ctypes.data_as(ctypes.c_void_p),
        signif.ctypes.data_as(ctypes.c_void_p),
        nthreads,
    )
    return dict(plane=plane, mvk=mvk, bcode=bcode, rloc=rloc,
                changed=changed.astype(bool), signif=signif.astype(bool),
                errors=errors)


class NativeScreenPressorEncoder:
    """Native twin of encode.sp_enc.ScreenPressorEncoder (byte-identical
    output for identical inputs: same greedy predictor/run/motion choices)."""

    KIND_AUTO, KIND_I, KIND_FLAT = 0, 1, 2

    def __init__(self, version: int, width: int, height: int, bpp: int = 24):
        lib = load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._h = lib.spenc_create(version, width, height, bpp)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.spenc_destroy(self._h)
            self._h = None

    def _encode(self, frame: np.ndarray, kind: int) -> bytes:
        n = self._lib.spenc_encode(self._h, np.ascontiguousarray(frame, np.uint32), kind)
        if n < 0:
            raise ValueError("unencodable symbol (v3 Cx6 interval overshoot)")
        ptr = self._lib.spenc_data(self._h)
        return ctypes.string_at(ptr, n)

    def encode_i(self, frame: np.ndarray) -> bytes:
        return self._encode(frame, self.KIND_I)

    def encode_p(self, frame: np.ndarray) -> bytes:
        return self._encode(frame, self.KIND_AUTO)

    def encode_flat(self, clr: int) -> bytes:
        return self._encode(np.full(1, clr, np.uint32), self.KIND_FLAT)


class NativeMsv1:
    """Native twin of codecs.msvideo1 MSVideo1_16bit/_8bit decode."""

    def __init__(self, width: int, height: int,
                 palette: Optional[np.ndarray] = None):
        lib = load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        lib.msv1_create.restype = ctypes.c_void_p
        lib.msv1_create.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.msv1_destroy.argtypes = [ctypes.c_void_p]
        lib.msv1_preinit.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.msv1_decompress.restype = ctypes.c_int
        lib.msv1_decompress.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int)]
        lib.msv1_latest.restype = ctypes.POINTER(ctypes.c_uint32)
        lib.msv1_latest.argtypes = [ctypes.c_void_p]
        self._pal = (np.ascontiguousarray(palette, np.uint32)
                     if palette is not None else None)
        palp = (self._pal.ctypes.data_as(ctypes.c_void_p)
                if self._pal is not None else None)
        self._h = lib.msv1_create(width, height, palp)
        self.X, self.Y = width, height

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.msv1_destroy(self._h)
            self._h = None

    def preinit(self, insignificant_lines: int) -> None:
        self._lib.msv1_preinit(self._h, insignificant_lines)

    def decompress(self, data: bytes, copy: bool = True):
        """→ (frame u32[X*Y] | None-if-no-change, signif)."""
        dst = np.zeros(self.X * self.Y, dtype=np.uint32) if copy else None
        dstp = dst.ctypes.data_as(ctypes.c_void_p) if copy else None
        signif = ctypes.c_int(0)
        r = self._lib.msv1_decompress(self._h, data, len(data), dstp,
                                      ctypes.byref(signif))
        if r != 0:
            return None, bool(signif.value)
        if copy:
            return dst, bool(signif.value)
        ptr = self._lib.msv1_latest(self._h)
        return np.ctypeslib.as_array(ptr, shape=(self.X * self.Y,)), \
            bool(signif.value)


def lane_compose_available() -> bool:
    lib = load()
    return lib is not None and hasattr(lib, "lane_compose_range")


def native_lane_compose_range(plane: np.ndarray, pool: np.ndarray,
                              units: np.ndarray, Y: int, X: int, Xp: int,
                              K: int, NB: int, T: int, t0: int, t1: int,
                              changed: np.ndarray, btype: np.ndarray,
                              rect: np.ndarray, mvk: np.ndarray,
                              row_ptr: np.ndarray, rows: np.ndarray,
                              refs: np.ndarray) -> None:
    """Walk frames [t0, t1) of one lane window in place on `plane`
    ([Y, X] u32 flattened) — the C twin of lane_host.compose_steps'
    changed-frame body (scatter → motion gather → rect paint → pool
    restore).  `pool` is the caller's zeroed [Y*Xp] u32 scratch; the
    call preserves its zero invariant."""
    lib = load()
    r = lib.lane_compose_range(plane, pool, units, Y, X, Xp, K, NB, T,
                               t0, t1, changed, btype, rect, mvk,
                               row_ptr, rows, refs)
    if r != 0:
        raise RuntimeError(f"lane_compose_range failed ({r})")

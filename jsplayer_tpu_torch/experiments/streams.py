"""The bench-mix stream: one ScreenPressor v4 stream of screen content.

A copy of the recipe of ``bench.real_stream_commands`` (bench.py): twelve
window paints on a flat desktop, then T-1 P-frames in which every third
frame scrolls the screen down 8 rows (motion blocks), a small paint lands
on two frames of every three, and every third frame is a still.  The
port's native encoder (jsplayer_tpu_torch.native) encodes it; the native
decoder writes the kmv transport (K=2); still-elision drops the unchanged
frames.  Nothing is cached on disk.
"""

from __future__ import annotations

import numpy as np

from ..kernels.sp_recon import compact_changed


def bench_mix_stream(Y: int = 1080, X: int = 1920, T: int = 64,
                     seed: int = 0) -> list[bytes]:
    """→ the encoded frames (T chunks, a keyframe first).  Needs the native
    library, and X >= 256, Y >= 160 for the paint rectangles."""
    from .. import native
    from ..encode.sp_enc import pack_rgb

    if not native.available():
        raise RuntimeError("the native SP encoder library is unavailable")
    rng = np.random.default_rng(seed)
    enc = native.NativeScreenPressorEncoder(4, X, Y)
    f = np.full((Y, X), pack_rgb(30, 30, 34), dtype=np.uint32)
    for _ in range(12):
        x0 = int(rng.integers(0, X - 200))
        y0 = int(rng.integers(0, Y - 150))
        f[y0: y0 + 140, x0: x0 + 190] = pack_rgb(*rng.integers(0, 256, 3))
    f = f.reshape(-1)
    st = [enc.encode_i(f)]
    for t in range(T - 1):
        nf = f.copy().reshape(Y, X)
        if t % 3 == 0:
            nf[8:, :] = nf[:-8, :].copy()  # scroll → motion blocks
        if t % 3 != 2:  # every third frame is a still
            x0 = int(rng.integers(0, X - 120))
            y0 = int(rng.integers(0, Y - 80))
            nf[y0: y0 + 60, x0: x0 + 100] = pack_rgb(
                *rng.integers(0, 256, 3))
        f = nf.reshape(-1)
        st.append(enc.encode_p(f))
    return st


def bench_mix_kmv(Y: int = 1080, X: int = 1920, T: int = 64, seed: int = 0,
                  K: int = 2):
    """The stream decoded to the kmv transport and compacted to its changed
    frames → (paycode [T', Y, X] u32, mvk [T', K, 2] i32, outmap [T] i32:
    the compacted row holding each timeline frame, -1 for the init
    frame)."""
    from .. import native

    kmv = native.native_sp_decode_streams_kmv(
        [bench_mix_stream(Y, X, T, seed)], X, Y, K=K)
    if kmv["errors"]:
        raise RuntimeError(f"native kmv decode: {kmv['errors']} frames "
                           f"failed")
    return compact_changed(kmv["paycode"][0], kmv["mvk"][0],
                           kmv["changed"][0])

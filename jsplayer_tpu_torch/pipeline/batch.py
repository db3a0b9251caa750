"""Host command assembly for batched ScreenPressor decode.

``stack_sp_commands`` is a copy of jsplayer_tpu/pipeline/batch.py's (that
module imports jax at the top, which the port never does; its sharded
device steps are ROADMAP.md queue 1 item 13).  tests/test_torch_validate.py
pins the copy against the original.
"""

from __future__ import annotations

import numpy as np

from ..codecs.screenpressor import ScreenPressor


def stack_sp_commands(
    streams: list[list[bytes]], X: int, Y: int, bpp: int = 24, gops: int = 1,
    insignificant_lines: int = 0,
) -> dict[str, np.ndarray]:
    """Run the SP host stage (entropy decode + command capture) over per-frame
    streams → [B, G, T, ...] stacks for kernels/sp_recon.  When gops > 1,
    each GOP must start with an I-frame (keyframe-delimited segments)."""
    B = len(streams)
    T_total = len(streams[0])
    assert T_total % gops == 0
    Tg = T_total // gops
    nbx, nby = (X + 15) // 16, (Y + 15) // 16
    nb = nbx * nby
    bts = np.zeros((B, T_total, nb), dtype=np.int32)
    mv = np.zeros((B, T_total, nb, 2), dtype=np.int32)
    rect = np.zeros((B, T_total, nb, 4), dtype=np.int32)
    payload = np.zeros((B, T_total, Y, X), dtype=np.uint32)
    changed = np.zeros((B, T_total), dtype=bool)
    from .. import native as _native

    if _native.available():
        # one parallel native call decodes all streams (thread pool = the
        # host-side DP axis)
        got = _native.native_sp_decode_streams(
            streams, X, Y, bpp=bpp, insignificant_lines=insignificant_lines)
        rs = lambda a: a.reshape(B, gops, Tg, *a.shape[2:])
        return dict(bts=rs(got["bts"]), mv=rs(got["mv"]), rect=rs(got["rect"]),
                    payload=rs(got["payload"]), changed=rs(got["changed"]))

    for b, frames in enumerate(streams):
        dec = ScreenPressor(X, Y, bpp)
        dec.preinit(insignificant_lines)
        for t, src in enumerate(frames):
            cap: dict = {}
            dec.capture = cap
            dst = np.zeros(X * Y, dtype=np.uint32)
            if dec.is_key_frame(src):
                dec.decompress_i(src, dst)
            else:
                dec.decompress_p(src, dst)
            bts[b, t] = cap["bts"]
            mv[b, t] = cap["mv"]
            rect[b, t] = cap["rect"]
            changed[b, t] = cap["changed"]
            data = dec.previous_frame()
            if data is not None:
                payload[b, t] = data.reshape(Y, X)
    rs = lambda a: a.reshape(B, gops, Tg, *a.shape[2:])
    return dict(bts=rs(bts), mv=rs(mv), rect=rs(rect), payload=rs(payload),
                changed=rs(changed))

"""Stream transcoding: legacy ScreenPressor versions → v4 / lane formats.

A product utility the reference never had: decode any supported SP stream
(v2 range-coded included) with the native decoder and re-encode with the
native v4 (rANS) encoder — e.g. to consolidate archives onto the fastest
decode path — or re-chunk payload symbols into the interleaved-lane rANS
format (kernels/rans_lanes.py) for device-side entropy decode.

Frame-level parity is preserved by construction: the transcoder decodes to
pixels and re-encodes losslessly (the encoder round-trip suite guarantees
decode(encode(f)) == f).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .core.chunkbuffer import ChunkBuffer
from .core.riff import AviDemuxer
from .core.types import CodecType, VideoInfo
from .encode.avi_mux import mux_avi


def transcode_sp(avi_bytes: bytes, target_version: int = 4,
                 use_native: Optional[bool] = None, jobs: int = 1) -> bytes:
    """Re-encode an SP AVI to `target_version`; returns the new AVI bytes.

    jobs > 1 (or 0 = all cores) transcodes keyframe-delimited GOPs in
    parallel — GOPs are the stream's only independent units
    (DataLoader.GetNearestKeyframe semantics), and the decoder/encoder
    entropy state resets at every I-frame, so per-GOP codecs produce the
    same bytes as a continuous pass.  ctypes releases the GIL during the
    native calls, so Python threads give real parallelism."""
    from . import native as _native

    if use_native is None:
        use_native = _native.available()

    buf = ChunkBuffer()
    frames: list[bytes] = []
    info: list[VideoInfo] = []
    d = AviDemuxer(buf, on_frame=frames.append, on_video_info=info.append)
    d.start()
    buf.add_chunk(avi_bytes)
    d.pump()
    d.signal_eof()
    d.pump()
    if not info:
        raise ValueError("no video stream found")
    vi = info[0]
    if vi.codec != CodecType.SCREENPRESSOR:
        raise ValueError("transcode_sp handles ScreenPressor inputs only")

    X, Y = vi.width, vi.height
    import os as _os

    if jobs == 0:
        jobs = _os.cpu_count() or 1
    if jobs > 1:
        return _transcode_parallel(frames, vi, target_version, use_native,
                                   jobs)
    if use_native:
        dec = _native.NativeScreenPressor(X, Y, vi.bpp)
        dec.preinit(0)
        enc = _native.NativeScreenPressorEncoder(target_version, X, Y, vi.bpp)
    else:
        from .codecs.screenpressor import ScreenPressor
        from .encode.sp_enc import ScreenPressorEncoder

        dec = ScreenPressor(X, Y, vi.bpp)
        dec.preinit(0)
        enc = ScreenPressorEncoder(target_version, X, Y, vi.bpp)

    out_streams: list[bytes] = []
    keyflags: list[bool] = []
    prev_px: Optional[np.ndarray] = None
    for t, src in enumerate(frames):
        if use_native:
            isk = dec.is_key_frame(src)
            view, _sig, _ = dec.decompress(src, isk, copy=False)
            px = np.asarray(view if view is not None else dec.latest_view())
        else:
            dst = np.zeros(X * Y, dtype=np.uint32)
            if dec.is_key_frame(src):
                dec.decompress_i(src, dst)
                px = dst
                isk = True
            else:
                res = dec.decompress_p(src, dst)
                px = np.asarray(res.data)
                isk = False
        if isk:
            data = enc.encode_i(px)
        else:
            data = enc.encode_p(px)
        out_streams.append(data)
        keyflags.append(isk or t == 0)
        prev_px = px

    return mux_avi(out_streams, X, Y, vi.bpp, codec=f"SPV{target_version}",
                   fps=vi.fps, keyflags=keyflags)


def transcode_to_lane(avi_bytes: bytes, window: int = 64, K: int = 2,
                      n_lanes: Optional[int] = None,
                      use_native: Optional[bool] = None,
                      payload: str = "raw",
                      compress: bool = True,
                      align: str = "keyframes",
                      jobs: int = 1) -> bytes:
    """Re-encode a supported AVI (ScreenPressor v2/v3/v4 or MSVideo1
    8/16-bit) into the lane-container format (codecs/lane_format) so the
    host never touches entropy after demux (BASELINE config 4
    end-to-end).  SP inputs carry their captured command stream; MSV1
    inputs synthesize data-block commands from the decoded pixel diff
    (_diff_commands) — one serving container for both reference codecs.

    payload: "raw" (default — uncoded u24 unit bytes, zero device entropy
    work; measured round 4 as both smaller and faster than rans on every
    corpus) or "rans" (renorm-aligned multi-lane rANS decoded on device
    at ~2 Gsym/s — kept for layouts that genuinely compress under a
    static table).  compress=True deflates each window's bulk section at
    rest (zlib level 1; screen content shrinks ~10-30x).

    The host stage decodes once with command capture (the same
    oracle/native path ingest uses) and derives per-window lane records;
    parity with the source AVI is by construction (derive_window mirrors
    prepare_kmv's pixel semantics, tests/test_lane_container.py).

    jobs > 1 (or 0 = all cores) derives restart-delimited units (runs of
    windows starting at a keyframe) in parallel with per-unit fresh
    decoders — byte-identical to the serial pass, since keyframes reset
    all decode state.  This is the dense-content migration lever: the
    one-time transcode pays the legacy per-symbol entropy wall
    (ANS.hx:785-860 semantics), and GOPs are its only independent
    units."""
    from . import native as _native
    from .codecs import lane_format

    if use_native is None:
        use_native = _native.available()

    buf = ChunkBuffer()
    frames: list[bytes] = []
    info: list[VideoInfo] = []
    sound: list[bytes] = []
    d = AviDemuxer(buf, on_frame=frames.append, on_video_info=info.append,
                   on_sound=sound.append)
    d.start()
    buf.add_chunk(avi_bytes)
    d.pump()
    d.signal_eof()
    d.pump()
    if not info:
        raise ValueError("no video stream found")
    vi = info[0]
    is_msv = vi.codec in (CodecType.MSVC16, CodecType.MSVC8)
    if not is_msv and vi.codec != CodecType.SCREENPRESSOR:
        raise ValueError(f"transcode_to_lane: unsupported codec {vi.codec}")
    X, Y = vi.width, vi.height
    if n_lanes is None:
        # 4096 lanes: 2,050 Msym/s on v5e (vs 1,474 @2048, 2,185 @8192 —
        # the knee; wire cost per symbol is N-independent at 2 B/sym)
        n_lanes = 4096 if X * Y >= (1 << 20) else 128
    nbx, nby = (X + 15) // 16, (Y + 15) // 16
    nb = nbx * nby
    if is_msv:
        # MSVideo1 (CRAM) has no SP command stream: decode to pixels and
        # synthesize data-block commands from the per-frame diff — the
        # lane container becomes the universal serving format for BOTH
        # reference codecs (MSVideo1.hx:106-209 block paint; pixels are
        # carried as u24, so 8-bit palettes must keep the high byte 0,
        # as the reference's quad layout does — MSVideo1.hx:281-291)
        if vi.codec == CodecType.MSVC8:
            from .codecs.msvideo1 import MSVideo1_8bit

            dec = MSVideo1_8bit(X, Y, vi.palette or b"")
        else:
            from .codecs.msvideo1 import MSVideo1_16bit

            dec = MSVideo1_16bit(X, Y)
        dec.preinit(0)
    else:
        dec, _enc = _make_codecs(vi, 4, use_native)

    cont = lane_format.LaneContainer(
        # MSV1 pixels are palette/RGB15-resolved to RGB888 at decode, so
        # the container records bpp=24 (consumers must NOT re-apply the
        # SP-16bpp display shift); SP streams keep their source bpp
        X=X, Y=Y, bpp=(24 if is_msv else vi.bpp), K=K, n_lanes=n_lanes,
        n_frames=len(frames), window=window, fps=vi.fps,
        audio=(b"".join(sound) if sound else None))
    # Keyframe-aligned window scheduling (same snap-down rule as the
    # ingest scheduler, pipeline/ingest._window_starts): a window whose
    # first frame is a keyframe derives as a restart window — the lane
    # analog of seek-from-keyframe (Manager.hx:244-249) — so snapping
    # boundaries to source keyframes makes every GOP lead a clip-seek /
    # gop-shard entry point instead of chaining the whole file to one
    # carry (measured: terminal-corpus Player seek p90 1.4 s → ~60 ms).
    from .pipeline.gop import snap_window_starts

    if align == "keyframes":
        # every GOP lead becomes a restart window — the lane analog of
        # seek-from-keyframe (Manager.hx:244-249); window lengths vary
        keys = [t for t, src in enumerate(frames) if t == 0
                or (src and dec.is_key_frame(src))]
        starts = snap_window_starts(keys, len(frames), window)
    elif align == "stride":
        # fixed-stride boundaries: all containers built with the same
        # `window` share boundaries regardless of keyframe cadence, so
        # heterogeneous archives stay batchable on one (dp, gop) mesh
        # (ingest._iter_lane requires shared boundaries across a batch)
        starts = list(range(0, len(frames), window)) if frames else []
    else:
        raise ValueError(f"align must be 'keyframes' or 'stride': {align!r}")
    bounds = list(zip(starts, starts[1:] + [len(frames)]))

    import os as _os

    if jobs == 0:
        jobs = _os.cpu_count() or 1
    if jobs > 1:
        # Restart-delimited units: a window whose start frame is a
        # keyframe decodes from a zero-init decoder (the gop-shard
        # independence the ingest scheduler already relies on), so runs
        # of windows between such starts are the stream's independent
        # work units.  Mid-GOP windows chain on the previous window's
        # carry and must stay in the same unit.  Unit boundaries — not
        # window boundaries — are the parallel grain, so jobs>1 output
        # is byte-identical to serial (dedup and span encoding are both
        # per-window, lane_format).
        if align == "keyframes":
            keyset = set(keys)
        else:
            keyset = {t for t, src in enumerate(frames)
                      if t == 0 or (src and dec.is_key_frame(src))}
        units: list[list[tuple[int, int]]] = []
        for b in bounds:
            if units and b[0] not in keyset:
                units[-1].append(b)
            else:
                units.append([b])
    else:
        units = [bounds] if bounds else []

    if jobs > 1 and len(units) > 1:
        from concurrent.futures import ThreadPoolExecutor

        def run_unit(unit):
            return _derive_lane_unit(
                frames, unit, _make_lane_decoder(vi, use_native), is_msv,
                use_native, X, Y, nbx, nby, K, n_lanes, payload)

        with ThreadPoolExecutor(max_workers=jobs) as ex:
            for ws in ex.map(run_unit, units):
                cont.windows.extend(ws)
    elif bounds:
        cont.windows.extend(_derive_lane_unit(
            frames, bounds, dec, is_msv, use_native, X, Y, nbx, nby, K,
            n_lanes, payload))
    return lane_format.container_to_bytes(cont, compress=compress)


def _make_lane_decoder(vi: VideoInfo, use_native: bool):
    """Fresh zero-init decoder for one restart unit (transcode_to_lane
    jobs>1).  Starting each unit at a keyframe makes this equivalent to
    the serial single-decoder pass (DataLoader.hx:125-132 GOP
    independence)."""
    X, Y = vi.width, vi.height
    if vi.codec == CodecType.MSVC8:
        from .codecs.msvideo1 import MSVideo1_8bit

        dec = MSVideo1_8bit(X, Y, vi.palette or b"")
    elif vi.codec == CodecType.MSVC16:
        from .codecs.msvideo1 import MSVideo1_16bit

        dec = MSVideo1_16bit(X, Y)
    elif use_native:
        from . import native as _native

        dec = _native.NativeScreenPressor(X, Y, vi.bpp)
    else:
        from .codecs.screenpressor import ScreenPressor

        dec = ScreenPressor(X, Y, vi.bpp)
    dec.preinit(0)
    return dec


def _derive_lane_unit(frames, unit_bounds, dec, is_msv, use_native,
                      X, Y, nbx, nby, K, n_lanes, payload):
    """Decode one restart unit's frames and derive its lane windows.
    `dec` must be positioned at the unit's first frame: either the
    serial pass's continuing decoder, or a fresh zero-init one when the
    unit starts at a keyframe (jobs>1)."""
    from .codecs import lane_format

    nb = nbx * nby
    prev_px = np.zeros((Y, X), dtype=np.uint32)
    out: list = []
    for start, end in unit_bounds:
        chunk = frames[start:end]
        T = len(chunk)
        bts = np.zeros((T, nb), dtype=np.int32)
        mv = np.zeros((T, nb, 2), dtype=np.int32)
        rect = np.zeros((T, nb, 4), dtype=np.int32)
        pixbuf = np.zeros((T, Y, X), dtype=np.uint32)
        changed = np.zeros(T, dtype=bool)
        sig = np.zeros(T, dtype=bool)
        for t, src in enumerate(chunk):
            if is_msv:
                dst = np.zeros(X * Y, dtype=np.uint32)
                if dec.is_key_frame(src):
                    dec.decompress_i(src, dst)
                    sig[t] = True
                    cur = dec.previous_frame()
                    pixbuf[t] = (np.asarray(cur).reshape(Y, X)
                                 if cur is not None else prev_px)
                    # a keyframe becomes a full-frame data paint (the
                    # I-frame capture shape), NOT a pixel diff: only that
                    # shape derives as a restart window, and without
                    # restarts an MSV1-sourced container has no clip-seek
                    # or gop-shard entry points — Player seek would decode
                    # from frame 0 (advisor r4, transcode.py)
                    bts[t] = 1
                    rect[t] = lane_format.block_full_rects(X, Y, nbx, nby)
                    changed[t] = True
                else:
                    res = dec.decompress_p(src, dst)
                    sig[t] = bool(res.significant_changes)
                    cur = dec.previous_frame()
                    pixbuf[t] = (np.asarray(cur).reshape(Y, X)
                                 if cur is not None else prev_px)
                    bts[t], rect[t], changed[t] = _diff_commands(
                        pixbuf[t], prev_px, X, Y, nbx, nby)
                prev_px = pixbuf[t]
                continue
            if use_native:
                isk = dec.is_key_frame(src)
                view, s, cap = dec.decompress(src, isk, capture=True,
                                              copy=False)
                if view is None:
                    view = dec.latest_view()
                pixbuf[t] = np.asarray(view).reshape(Y, X)
                sig[t] = bool(s)
            else:
                cap = {}
                dec.capture = cap
                dst = np.zeros(X * Y, dtype=np.uint32)
                if dec.is_key_frame(src):
                    dec.decompress_i(src, dst)
                    sig[t] = True
                else:
                    res = dec.decompress_p(src, dst)
                    sig[t] = bool(res.significant_changes)
                pixbuf[t] = dec.previous_frame().reshape(Y, X)
            bts[t], mv[t], rect[t] = cap["bts"], cap["mv"], cap["rect"]
            changed[t] = cap["changed"]
        out.append(lane_format.derive_window(
            bts, mv, rect, pixbuf, changed, sig, X, Y, K, n_lanes,
            payload_mode=payload))
    return out


def _diff_commands(px: np.ndarray, prev: np.ndarray, X: int, Y: int,
                   nbx: int, nby: int):
    """Synthesize SP-shaped data-block commands from a pixel diff: each
    16x16 block whose pixels changed becomes a data block whose rect is
    the tight bounding box of the change (absolute coords, the capture
    convention derive_window expects).  Used by the MSVideo1 lane path,
    which has no native command stream."""
    nb = nbx * nby
    bts = np.zeros(nb, dtype=np.int32)
    rect = np.zeros((nb, 4), dtype=np.int32)
    diff = px != prev
    if not diff.any():
        return bts, rect, False
    d = np.zeros((nby * 16, nbx * 16), dtype=bool)
    d[:Y, :X] = diff
    blk = d.reshape(nby, 16, nbx, 16).any(axis=(1, 3))
    for by, bx in zip(*np.nonzero(blk)):
        b = d[by * 16 : (by + 1) * 16, bx * 16 : (bx + 1) * 16]
        ys, xs = np.nonzero(b)
        i = by * nbx + bx
        bts[i] = 1
        rect[i] = (bx * 16 + xs.min(), by * 16 + ys.min(),
                   min(bx * 16 + xs.max() + 1, X),
                   min(by * 16 + ys.max() + 1, Y))
    return bts, rect, True


def _make_codecs(vi: VideoInfo, target_version: int, use_native: bool):
    X, Y = vi.width, vi.height
    if use_native:
        from . import native as _native

        dec = _native.NativeScreenPressor(X, Y, vi.bpp)
        enc = _native.NativeScreenPressorEncoder(target_version, X, Y, vi.bpp)
    else:
        from .codecs.screenpressor import ScreenPressor
        from .encode.sp_enc import ScreenPressorEncoder

        dec = ScreenPressor(X, Y, vi.bpp)
        enc = ScreenPressorEncoder(target_version, X, Y, vi.bpp)
    dec.preinit(0)
    return dec, enc


def _transcode_gop(gop_frames, vi, target_version, use_native):
    X, Y = vi.width, vi.height
    dec, enc = _make_codecs(vi, target_version, use_native)
    out, keyflags = [], []
    for t, src in enumerate(gop_frames):
        if use_native:
            isk = dec.is_key_frame(src)
            view, _sig, _ = dec.decompress(src, isk, copy=False)
            px = np.asarray(view if view is not None else dec.latest_view())
        else:
            dst = np.zeros(X * Y, dtype=np.uint32)
            if dec.is_key_frame(src):
                dec.decompress_i(src, dst)
                px, isk = dst, True
            else:
                res = dec.decompress_p(src, dst)
                px, isk = np.asarray(res.data), False
        out.append(enc.encode_i(px) if isk else enc.encode_p(px))
        keyflags.append(isk or t == 0)
    return out, keyflags


def _transcode_parallel(frames, vi, target_version, use_native, jobs):
    from concurrent.futures import ThreadPoolExecutor

    from .pipeline.gop import split_gops
    from . import native as _native

    if use_native:
        probe = _native.NativeScreenPressor(vi.width, vi.height, vi.bpp)
        keys = [bool(probe.is_key_frame(f)) for f in frames]
    else:
        from .codecs.screenpressor import ScreenPressor

        probe = ScreenPressor(vi.width, vi.height, vi.bpp)
        keys = [bool(probe.is_key_frame(f)) for f in frames]
    gops = split_gops(frames, keys)
    with ThreadPoolExecutor(max_workers=jobs) as ex:
        parts = list(ex.map(
            lambda g: _transcode_gop(g[1], vi, target_version, use_native),
            gops))
    out_streams, keyflags = [], []
    for streams_g, keys_g in parts:
        out_streams.extend(streams_g)
        keyflags.extend(keys_g)
    keyflags[0] = True
    return mux_avi(out_streams, vi.width, vi.height, vi.bpp,
                   codec=f"SPV{target_version}", fps=vi.fps,
                   keyflags=keyflags)

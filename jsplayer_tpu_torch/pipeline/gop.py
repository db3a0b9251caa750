"""GOP segmentation — the sequence-parallel axis scheduler.

Keyframe-delimited GOPs are the only independent decode units
(DataLoader.GetNearestKeyframe, DataLoader.hx:125-132; P-frames chain on the
previous frame, ScreenPressor.hx:302-484), which makes them the natural
shard unit for the `gop` mesh axis (SURVEY.md §2 SP/CP row).  This module
turns a stream's (frames, keyflags) into fixed-shape GOP segments for the
sharded batch decoder: each segment starts at a keyframe and pads its tail
with empty frames (= "no change" for both codecs), so [B, G, T] command
stacks are rectangular without re-architecting short streams.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence


@dataclass
class GopSegment:
    start_frame: int  # index of the segment's first frame in the stream
    frames: list[bytes]  # padded to segment_len
    n_real: int  # un-padded frame count
    independent: bool = True  # True iff frames[0] is a keyframe: decodable
    # from a zero init.  Sub-windows of a long GOP are dependent — they must
    # be decoded with the previous window's carry (pipeline/ingest.py), not
    # as standalone gop shards.


def split_gops(frames: Sequence[bytes], keyflags: Sequence[bool]
               ) -> list[tuple[int, list[bytes]]]:
    """Split at keyframes → [(start_index, frames...)]. Leading non-key
    frames (possible after a mid-file join) go into a first segment that
    decodes as no-change until its first keyframe."""
    bounds = [i for i, k in enumerate(keyflags) if k]
    if not bounds or bounds[0] != 0:
        bounds = [0] + bounds
    out = []
    for i, s in enumerate(bounds):
        e = bounds[i + 1] if i + 1 < len(bounds) else len(frames)
        out.append((s, list(frames[s:e])))
    return out


def segment_stream(frames: Sequence[bytes], keyflags: Sequence[bool],
                   segment_len: int) -> list[GopSegment]:
    """GOPs re-chunked to a fixed segment length: long GOPs split into
    dependent sub-windows (flagged by n_real/start bookkeeping — consumers
    that need independence must keep sub-windows of one GOP on the same
    device, which `pipeline.batch` guarantees by putting them in consecutive
    gop slots), short GOPs pad with empty no-change frames."""
    segs: list[GopSegment] = []
    for start, g in split_gops(frames, keyflags):
        for off in range(0, len(g), segment_len):
            part = g[off : off + segment_len]
            n_real = len(part)
            part = part + [b""] * (segment_len - n_real)
            segs.append(GopSegment(start + off, part, n_real,
                                   independent=(off == 0)))
    return segs


def pack_batch(segs: list[GopSegment], gops_per_stream: int
               ) -> list[list[GopSegment]]:
    """Group segments into per-device-slot lists of equal length, padding
    with empty all-no-change segments."""
    seglen = len(segs[0].frames) if segs else 0
    rows = []
    for i in range(0, len(segs), gops_per_stream):
        row = segs[i : i + gops_per_stream]
        while len(row) < gops_per_stream:
            row.append(GopSegment(-1, [b""] * seglen, 0, independent=True))
        rows.append(row)
    return rows


def snap_window_starts(keys: Sequence[int], n_frames: int,
                       window: int) -> list[int]:
    """Keyframe-aligned window boundaries: each boundary snaps DOWN to the
    latest keyframe within `window` of the previous start (the reference's
    seek logic thinks in keyframe units, Manager.hx:244-249).  Shared by
    the ingest scheduler and transcode_to_lane — both must produce the
    same boundaries or a lane batch's streams desynchronize
    (ingest._iter_lane validates shared boundaries)."""
    if n_frames <= 0:
        return []
    starts = [0]
    while True:
        s = starts[-1]
        k = max((k for k in keys if s < k <= s + window), default=None)
        nxt = k if k is not None else s + window
        if nxt >= n_frames:
            break
        starts.append(nxt)
    return starts

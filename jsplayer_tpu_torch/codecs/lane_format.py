"""Lane-container stream format — device-entropy re-encode of SP streams.

BASELINE config 4 end-to-end (VERDICT round-2 item 1): a re-encoded stream
whose payload the device decodes wholesale — after demux the host never
touches entropy, removing the system bottleneck (host ~3-5k fps/core for
legacy streams vs ~30k device fps).

Design (TPU-first; the reference has no analog — its entropy is inherently
host/serial, ANS.hx adaptive contexts):

* Frame commands are the kmv compose's semantics (ScreenPressor.hx:302-484
  via kernels/sp_recon.derive_kmv_commands): per 16x16 block a type
  (0 copy / 1 data-in-rect / 2+k motion-slot-k-in-rect), a block-local rect,
  and K per-frame motion vectors.  Stored sparsely (active blocks only).
* Payload pixels (data-block rect content) are serialized in 128-px
  LANE-ROW UNITS of the padded plane [Y, ceil(X/128)*128]: the device
  rebuilds each frame's data plane with a ROW GATHER (free on TPU) —
  no dynamic_update_slice chain, no 16x16 relayout, and FULL frames
  (keyframes) ride the identical machinery.
* Unit pixel bytes ride one of two PAYLOAD MODES (per-window flag):

  - **raw** (default since round 4): uncoded u24 byte-plane triplets
    [U, 3, 128] — 3 B/pixel on the wire, ZERO device entropy work (the
    unit build is a free reshape + combine).  Measured round 4: both
    smaller AND faster than the rANS mode on every corpus, because the
    renorm-aligned refill layout ships a fixed 2 B/SYMBOL (= 6 B/pixel)
    regardless of entropy.
  - **rans**: symbols entropy-coded with the renorm-aligned multi-lane
    rANS (kernels/rans_lanes, ~2 Gsym/s on-device) under a per-window
    static frequency table.  Kept for layouts whose device-side bytes
    genuinely compress below 1/2 B/sym under a static table — the
    aligned refill schedule can never beat raw for ≥1-B/sym content,
    so raw is the production default.

  Either way the symbol order is per-unit byte-plane triplets
  [U, 3, 128], so the device-side unpack is one free reshape +
  middle-dim slices + an elementwise combine, invariant under U
  bucketing (padded units decode to rows nothing references).

* Window-leading keyframes: in raw mode they are ordinary full-frame
  data paints riding the SAME unit machinery (3 B/px, no special case);
  in rans mode they ship as raw u32 init planes (4 B/px — entropy-coding
  a keyframe measured both slower and larger, round 3).  Windows whose
  first frame fully paints the plane are flagged RESTART — their decode
  is carry-independent, which is the gop-axis sharding unit and the
  clip-seek restart point (the reference's keyframe-seek analog,
  Manager.hx:244-249).

* Optional DEFLATE framing (per-window flag): the bulk section (payload
  or refills, plus any init plane) is zlib-compressed at rest.  Screen
  content deflates well (bench corpus ~30x); the host-side inflate is a
  one-shot per window, far off the per-frame path.

A container holds GOP-aligned windows; windows are independent decode
chains when restart-flagged, which is what the transcoder emits for
keyframe-led content.

SIZE (measured, round 4): raw+deflate turns the round-3 numbers around
— bench corpus 16.7 MB (rans, uncompressed) → well under the ≥3x-shrink
bar; see BENCH_NOTES.md round-4 A/B table.

Wire layout (little-endian):

  header:  "JLV1" | u16 X | u16 Y | u8 bpp | u8 K | u16 n_lanes
           | u32 n_frames | u16 window | u32 fps_num | u32 fps_den
  window record:
           u32 record_bytes (excluding this field)
           u16 T (frames in window) | u32 U (PAYLOAD units, deduped)
           | u32 n_active (blocks) | u32 steps (lane scan length; 0 raw)
           | u8 flags (bit0 init plane present | bit1 raw payload
                       | bit2 bulk deflated | bit3 restart window
                       | bit4 dedup indices present
                       | bit6 sub-unit payload encoding)
           changed[T] u8 | signif[T] u8 | mvk[T*K*2] i16
           per-frame active-block counts u32[T]
           meta section — two layouts, selected by flag bit5:
             legacy (bit5 clear):
               active blocks: (u32 block_index | u8 btype | u8 rect[4]) each
               per-frame unit REFERENCE counts u32[T] (sum = n_refs; == U
                 when no dedup indices)
               unit plane-row ids u32[n_refs]
               [payload unit indices u32[n_refs] if dedup flag]
             meta-deflated (bit5 set; the command/reference arrays
             deflate ~4.5x, a free win — the deflated terminal wire
             remains payload-dominated, see BENCH_NOTES):
               per-frame unit REFERENCE counts u32[T]
               u32 meta_clen
               zlib( active blocks | unit plane-row ids | [unit indices] )
           [u32 Us | u8 S if sub-unit flag (bit6; raw mode only)]
           [u32 bulk_clen if deflated]
           bulk (zlib-deflated when flagged):
             raw:  payload u8[U * 3 * 128], or with the sub-unit flag
                   span blob u8[Us * 3 * S]
                   | span ids as 2 (Us <= 65535) or 4 byte PLANES of
                     u8[U * (128/S)] each, lo bytes first (byte planes
                     deflate ~21% better than interleaved u16).  The
                     byte-plane id layout IS bit6's definition: an
                     interleaved-u16 draft existed for a few hours
                     inside round 4 and never shipped — containers
                     written before bit6 existed parse unchanged.
                   — S-px spans of the unit rows deduped (8-px spans ≈
                   glyph atoms; terminal payload 1.81 MB → ~0.39 MB,
                   scripts/exp_lane_subunits.py); the parser expands
                   back to [U, 3, 128] so consumers are unchanged.
                   Emitted pick-smaller per window vs the plain layout.
             rans: freq i32[256] | states u32[n_lanes]
                   | refills u8[steps * n_lanes * 2]
             then: init plane u32[Y * X] if flagged
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..kernels import rans_lanes
from ..kernels.sp_recon import derive_kmv_commands

_MAGIC = b"JLV1"
_AUDIO_MAGIC = b"JLAU"
_HDR = "<4sHHBBHIHII"


def plane_cols(X: int) -> int:
    """Padded plane width: payload units are 128-px lane rows."""
    return -(-X // 128) * 128


@dataclass
class LaneWindow:
    """One decoded window record (host arrays, ready for device_put)."""

    T: int
    changed: np.ndarray          # [T] bool
    signif: np.ndarray           # [T] bool
    mvk: np.ndarray              # [T, K, 2] int32
    btype: np.ndarray            # [T, NB] uint8 (dense; 0/1/2+k)
    rect: np.ndarray             # [T, NB, 4] uint8 (block-local x1,y1,x2,y2)
    unit_rows: list              # per frame: np.ndarray of plane-row ids
    n_units: int                 # U — PAYLOAD unit count (deduped)
    # unit-level dedup (round 4): identical payload units are stored once
    # and referenced by index — cursor blinks, repeated paints, and flat
    # keyframe rows collapse (bench corpus 197x, terminal 2.1x fewer
    # units).  None = references are implicitly sequential (no dedup).
    unit_idx: Optional[list] = None  # per frame: np.ndarray payload indices
    # rans payload mode (None in raw mode):
    freq: Optional[np.ndarray] = None     # [256] int32
    states: Optional[np.ndarray] = None   # [N] uint32
    refills: Optional[np.ndarray] = None  # [steps, N, 2] uint8
    # rans mode only: window-leading keyframe extracted as a RAW [Y, X]
    # u32 scan-init plane (entropy-coding a full 1080p frame is ~6M
    # symbols and ~16K latency-bound gather rows — dense is both FASTER
    # and SMALLER than its refill rows; frame 0 then stays in the scan
    # as an all-copy changed frame).  In raw mode keyframes are ordinary
    # full-paint frames in `payload` (3 B/px beats this plane's 4 B/px).
    init_plane: Optional[np.ndarray] = None
    # raw payload mode: uncoded unit byte-plane triplets [U, 3, 128] u8
    payload: Optional[np.ndarray] = None
    # frame 0 fully paints the plane → decode is carry-independent (the
    # gop-axis sharding unit and the clip-seek restart point)
    restart: bool = False

    @property
    def raw_mode(self) -> bool:
        return self.payload is not None

    def inv_index(self, R: int) -> np.ndarray:
        """[T, R] int32: plane row → payload unit index (0 where absent;
        the device compose masks absent rows out via the data-rect test).
        With dedup, references come from unit_idx; the device gather
        handles repeated indices natively."""
        inv = np.zeros((self.T, R), dtype=np.int32)
        off = 0
        for t, rows in enumerate(self.unit_rows):
            if self.unit_idx is not None:
                inv[t, rows] = self.unit_idx[t]
            else:
                inv[t, rows] = off + np.arange(rows.size, dtype=np.int32)
                off += rows.size
        return inv

    def row_index(self, Y: int, ncol: int):
        """Row-level dedup of the unit references (the device decode's
        input shape since round 4 — kernels/lane_recon module docstring):

          row_table [Ur, ncol] i32 — each unique plane row's per-128-px
            unit ids (row 'absent' slots are unit 0, masked out by the
            device's data-rect test exactly as inv_index's zeros were);
          row_idx [T, Y] i32 — per frame, each plane row's row_table id.

        The device assembles rows_unique [Ur, X] ONCE per window (the
        only relayout) and every frame then does a pure row gather —
        the [R,128]→[Y,X] per-frame reshape the slot layout paid was a
        lane-dim-merging relayout (~2x 8.3 MB/frame extra traffic;
        scripts/exp_lane_rowgather.py measured the fix +36% dense).

        Untouched rows map to the all-zero tuple; only touched rows pay
        host work, and the window-wide dedup is ONE void-view np.unique
        over the touched tuples."""
        row_idx = np.zeros((self.T, Y), dtype=np.int32)
        zero = np.zeros((1, ncol), dtype=np.int32)
        empty = np.zeros(0, dtype=np.int64)
        chunks = [zero]  # the all-zero tuple always exists (id via unique)
        locs = []
        off = 0
        for t, slots in enumerate(self.unit_rows):
            n = slots.size
            if self.unit_idx is not None:
                refs = self.unit_idx[t].astype(np.int32, copy=False)
            else:
                refs = off + np.arange(n, dtype=np.int32)
                off += n
            if n == 0:
                locs.append((t, empty))
                continue
            ys = (slots // ncol).astype(np.int64)
            # slots arrive row-major sorted (derive_window), so the
            # per-frame unique is a diff scan — np.unique's argsort was
            # the profile's whole cost at keyframe sizes
            if ys.size > 1 and (ys[1:] < ys[:-1]).any():
                order = np.argsort(ys, kind="stable")
                ys, refs = ys[order], refs[order]
                slots = slots[order]
            new = np.empty(ys.size, dtype=bool)
            new[0] = True
            np.not_equal(ys[1:], ys[:-1], out=new[1:])
            uy = ys[new]
            rid = np.cumsum(new) - 1
            tv = np.zeros((uy.size, ncol), dtype=np.int32)
            tv[rid, slots % ncol] = refs
            chunks.append(tv)
            locs.append((t, uy))
        allv = np.concatenate(chunks, axis=0)
        # u64-hash the tuples so unique sorts integers, not 64-byte void
        # keys (the void argsort was 8 of row_index's 10.8 ms/window);
        # the representative-compare guard catches any 64-bit collision
        # and falls back to the exact lexicographic path
        h = np.zeros(allv.shape[0], dtype=np.uint64)
        mult = np.uint64(0x9E3779B97F4A7C15)
        for j in range(ncol):
            h = h * mult + allv[:, j].astype(np.uint64)
        _, first, inverse = np.unique(h, return_index=True,
                                      return_inverse=True)
        row_table = allv[first]
        if not (row_table[inverse] == allv).all():
            allv = np.ascontiguousarray(allv)
            keys = allv.view([("", allv.dtype)] * ncol).ravel()
            _, first, inverse = np.unique(keys, return_index=True,
                                          return_inverse=True)
            row_table = allv[first]
        row_idx[:] = inverse[0]  # default: every row is the zero tuple
        pos = 1
        for t, uy in locs:
            row_idx[t, uy] = inverse[pos : pos + uy.size]
            pos += uy.size
        return row_table, row_idx


@dataclass
class LaneContainer:
    X: int
    Y: int
    bpp: int
    K: int
    n_lanes: int
    n_frames: int
    window: int
    fps: float
    windows: list = field(default_factory=list)  # list[LaneWindow]
    # raw MP3 audio passthrough: the source AVI's concatenated 01wb chunk
    # payloads (the reference's sound stream, MP3Parser.hx input) — the
    # lane re-encode must not silently drop audio.  None = no audio.
    audio: Optional[bytes] = None

    def window_bases(self) -> list:
        """Start frame of each window (prefix sums of window lengths —
        variable under keyframe-aligned scheduling)."""
        bases, b = [], 0
        for w in self.windows:
            bases.append(b)
            b += w.T
        return bases


def _block_local_rects(rect_g: np.ndarray, nbx: int) -> np.ndarray:
    """Global-coordinate block rects [NB, 4] → block-local u8 [NB, 4]."""
    nb = rect_g.shape[0]
    bx = (np.arange(nb) % nbx) * 16
    by = (np.arange(nb) // nbx) * 16
    loc = np.empty((nb, 4), dtype=np.int64)
    loc[:, 0] = rect_g[:, 0] - bx
    loc[:, 1] = rect_g[:, 1] - by
    loc[:, 2] = rect_g[:, 2] - bx
    loc[:, 3] = rect_g[:, 3] - by
    return np.clip(loc, 0, 16).astype(np.uint8)


def block_full_rects(X: int, Y: int, nbx: int, nby: int) -> np.ndarray:
    """Per-block full rects (absolute coords, clipped at the frame edge)
    — the I-frame capture shape derive_window recognizes as a restart
    window.  ONE definition shared with transcode's synthesized MSV1
    keyframes so the restart test stays byte-identical by construction."""
    NB = nbx * nby
    r = np.empty((NB, 4), dtype=np.int64)
    r[:, 0] = (np.arange(NB) % nbx) * 16
    r[:, 1] = (np.arange(NB) // nbx) * 16
    r[:, 2] = np.minimum(r[:, 0] + 16, X)
    r[:, 3] = np.minimum(r[:, 1] + 16, Y)
    return r


def derive_window(bts: np.ndarray, mv: np.ndarray, rect: np.ndarray,
                  payload: np.ndarray, changed: np.ndarray,
                  signif: np.ndarray, X: int, Y: int, K: int,
                  n_lanes: int, payload_mode: str = "raw") -> LaneWindow:
    """Host derivation: captured commands + decoded frames → a LaneWindow.

    Mirrors kernels/sp_recon.prepare_kmv's pixel semantics exactly (same
    derive_kmv_commands grouping, same demotion rule), so the device lane
    compose is bit-exact with the dense-paycode path by construction.

    payload_mode: "raw" (uncoded u24 unit bytes — the measured-default) or
    "rans" (renorm-aligned lane entropy; see module docstring)."""
    if payload_mode not in ("raw", "rans"):
        raise ValueError(f"unknown payload_mode {payload_mode!r}")
    T, NB = bts.shape
    nbx, nby = (X + 15) // 16, (Y + 15) // 16
    Xp = plane_cols(X)
    nxu = Xp // 128
    mvk, group, demoted = derive_kmv_commands(bts, mv, rect, K)

    btype = np.zeros((T, NB), dtype=np.uint8)
    rloc = np.zeros((T, NB, 4), dtype=np.uint8)
    unit_rows: list[np.ndarray] = []
    unit_idx_l: list[np.ndarray] = []
    uniq_px: list[np.ndarray] = []
    seen: dict = {}
    per_frame_units = np.zeros(T, dtype=np.int64)
    pay = payload & np.uint32(0x00FFFFFF)
    for t in range(T):
        is_mot_block = (bts[t] == 3) | (bts[t] == 4)
        data_blk = (bts[t] > 0) & ~is_mot_block
        loc = _block_local_rects(rect[t], nbx)
        sel = data_blk & ~demoted[t]
        btype[t, sel] = 1
        rloc[t, sel] = loc[sel]
        # demoted motion blocks carry full final content (prepare_kmv's
        # `is_data |= demoted` has no rect mask)
        btype[t, demoted[t]] = 1
        rloc[t, demoted[t]] = (0, 0, 16, 16)
        mot = (group[t] >= 0) & ~demoted[t]
        btype[t, mot] = (2 + group[t, mot]).astype(np.uint8)
        rloc[t, mot] = loc[mot]
    # window-leading keyframe: frame 0 a full-frame data paint (every
    # block data, full rects — the I-frame capture shape) makes the
    # window's decode carry-independent (`restart`).  The test reads the
    # DERIVED commands, exactly as the parser re-derives the flag
    # (_window_from_bytes): a capture whose frame 0 paints every block
    # with full-rect data blocks of another bts (2) is a restart too, and
    # a test on the raw bts would flag it False, which the parser then
    # rejects.  In rans mode frame 0 is additionally extracted as a raw
    # init plane (see LaneWindow.init_plane) and rides the scan as an
    # all-copy changed frame; in raw mode it rides the unit machinery
    # like any other frame (3 B/px < the plane's 4 B/px).
    full_loc = _block_local_rects(block_full_rects(X, Y, nbx, nby), nbx)
    restart = bool(T > 0 and changed[0] and (btype[0] == 1).all()
                   and (rloc[0] == full_loc).all())
    init_plane = None
    if restart and payload_mode == "rans":
        init_plane = pay[0].copy()
        btype[0] = 0
        rloc[0] = 0
    # reusable zero-padded unit-row plane: each unit row is a contiguous
    # 128-px span of the (padded) frame row, so unit values come from ONE
    # plain row gather instead of a [n, 128] broadcast fancy index with a
    # column-clip mask (3x on the dense-content transcode hot line); the
    # pad columns stay zero across frames
    padplane = np.zeros((Y * nxu, 128), dtype=np.uint32)
    for t in range(T):
        if t == 0 and init_plane is not None:
            # all-copy changed frame: the scan passes the init through
            unit_rows.append(np.zeros(0, dtype=np.int64))
            unit_idx_l.append(np.zeros(0, dtype=np.int64))
            continue
        if not changed[t]:
            unit_rows.append(np.zeros(0, dtype=np.int64))
            unit_idx_l.append(np.zeros(0, dtype=np.int64))
            continue
        # touched unit rows straight from the data-block rects — a 16-px
        # block spans at most two 128-px unit columns, so the (plane row,
        # unit column) pairs come from per-block row ranges instead of a
        # [Y, X] per-pixel mask (the mask build was ~90% of transcode
        # wall time at 1080p; exact same row set by construction)
        di = np.nonzero(btype[t] == 1)[0]
        r = rloc[t][di].astype(np.int64)
        gx1 = (di % nbx) * 16 + r[:, 0]
        gy1 = (di // nbx) * 16 + r[:, 1]
        gx2 = np.minimum((di % nbx) * 16 + r[:, 2], X)
        gy2 = np.minimum((di // nbx) * 16 + r[:, 3], Y)
        ok = (gx2 > gx1) & (gy2 > gy1)
        gx1, gy1, gx2, gy2 = gx1[ok], gy1[ok], gx2[ok], gy2[ok]
        if gx1.size:
            ny = gy2 - gy1
            # grouped arange: block b contributes rows gy1[b] .. gy2[b]-1
            off = np.concatenate(([0], np.cumsum(ny)[:-1]))
            ys = (np.arange(int(ny.sum()), dtype=np.int64)
                  - np.repeat(off, ny) + np.repeat(gy1, ny))
            c1 = np.repeat(gx1 // 128, ny)
            c2 = np.repeat((gx2 - 1) // 128, ny)
            ids = ys * nxu + c1
            two = c2 > c1
            rows = np.unique(
                np.concatenate([ids, ys[two] * nxu + c2[two]]))
        else:
            rows = np.zeros(0, dtype=np.int64)
        per_frame_units[t] = rows.size
        unit_rows.append(rows)
        if rows.size:
            # unit values: whole-row absolute content (XOR/masked variants
            # measured worse, scripts/exp_lane_xor.py), zero-padded past X;
            # refresh only the touched frame rows, then one contiguous
            # row gather
            yy = np.unique(rows // nxu)
            padplane.reshape(Y, Xp)[yy, :X] = pay[t][yy]
            sel = padplane[rows]
            # unit-level dedup: identical payload rows (cursor blinks,
            # repeated paints, flat keyframe background) store once and
            # reference by index — bench corpus 197x, terminal 2.1x
            idxs = np.empty(rows.size, dtype=np.int64)
            for j in range(rows.size):
                key = sel[j].tobytes()
                k = seen.get(key)
                if k is None:
                    k = len(uniq_px)
                    seen[key] = k
                    uniq_px.append(sel[j])
                idxs[j] = k
            unit_idx_l.append(idxs)
        else:
            unit_idx_l.append(np.zeros(0, dtype=np.int64))

    n_refs = int(per_frame_units.sum())
    U = len(uniq_px)
    units = (np.stack(uniq_px, axis=0) if U
             else np.zeros((0, 128), dtype=np.uint32))
    # no duplicates → references are sequential by construction; drop the
    # index arrays so the wire stays on the compact legacy layout
    unit_idx = None if U == n_refs else unit_idx_l
    # per-unit byte-plane triplets [U, 3, 128]: each unit's byte0 row, then
    # byte1, byte2.  The device unpack (lane_recon.units_from_pack) is a
    # free middle-dim reshape/slice and — crucially — stays correct when U
    # is padded to a bucket (a window-global plane split would shift the
    # byte-plane offsets with U)
    arr = np.empty((U, 3, 128), dtype=np.uint8)
    arr[:, 0] = units & 0xFF
    arr[:, 1] = (units >> 8) & 0xFF
    arr[:, 2] = (units >> 16) & 0xFF
    if payload_mode == "raw":
        return LaneWindow(T=T, changed=changed.astype(bool),
                          signif=signif.astype(bool),
                          mvk=mvk.astype(np.int32), btype=btype, rect=rloc,
                          unit_rows=unit_rows, unit_idx=unit_idx,
                          n_units=U, payload=arr, restart=restart)
    syms = arr.reshape(-1)
    freq = rans_lanes.build_freq_table(syms if syms.size
                                       else np.zeros(1, np.uint8))
    lane_bytes, states, ns = rans_lanes.encode_lanes(syms, freq, n_lanes)
    # exact step count on the wire — consumers pad refills to their own
    # shape buckets (pipeline/ingest does), so pow2-bucketing here only
    # inflated the container (~35% on the bench corpus)
    steps = max(1, -(-ns // n_lanes))
    refills = rans_lanes.layout_refills(lane_bytes, states, freq, steps)
    return LaneWindow(T=T, changed=changed.astype(bool),
                      signif=signif.astype(bool),
                      mvk=mvk.astype(np.int32), btype=btype, rect=rloc,
                      unit_rows=unit_rows, unit_idx=unit_idx,
                      n_units=U, freq=freq,
                      states=states, refills=refills, init_plane=init_plane,
                      restart=restart)


# ---------------------------------------------------------------------------
# Serialization
# ---------------------------------------------------------------------------

_FLAG_INIT = 1        # raw u32 init plane present (rans mode)
_FLAG_RAW = 2         # payload mode raw (uncoded u24 unit bytes)
_FLAG_DEFLATE = 4     # bulk section zlib-deflated at rest
_FLAG_RESTART = 8     # frame 0 fully paints the plane (carry-independent)
_FLAG_DEDUP = 16      # explicit payload-unit indices (unit dedup)
_FLAG_META = 32       # block/reference arrays zlib-deflated (see docstring)
_FLAG_SUBUNIT = 64    # payload stored as deduped S-px sub-unit spans + ids

# sub-unit span width: 8-px spans ≈ glyph atoms on screen content —
# measured (scripts/exp_lane_subunits.py) the terminal corpus's 21,572
# unique 128-px units collapse to ~1,053 unique 8-px spans, cutting the
# deflated payload section 1.81 MB → ~0.39 MB; S=16/32/64 all measured
# worse on the id/payload trade.  Wire carries S so this can change
# without a format break.
_SUBUNIT_S = 8


def _subunit_wire_size(n_uniq: int, n_subs: int, S: int) -> int:
    """Raw (pre-deflate) size of the sub-unit wire candidate: header +
    unique span records + id byte-planes — must mirror the sub_hdr /
    sub_bulk construction below exactly, it is the hoisted prefilter."""
    nby_id = 2 if n_uniq <= 0xFFFF else 4
    return 5 + n_uniq * 3 * S + n_subs * nby_id


def _window_to_bytes(w: LaneWindow, K: int, n_lanes: int,
                     compress: bool = True) -> bytes:
    import zlib

    T = w.T
    active = w.btype != 0
    n_active_t = active.sum(axis=1).astype(np.uint32)
    n_active = int(n_active_t.sum())
    blocks = bytearray()
    for t in range(T):
        idx = np.nonzero(active[t])[0]
        rec = np.empty((idx.size, 9), dtype=np.uint8)
        rec[:, 0:4] = idx.astype("<u4").reshape(-1, 1).view(np.uint8)
        rec[:, 4] = w.btype[t, idx]
        rec[:, 5:9] = w.rect[t, idx]
        blocks += rec.tobytes()
    unit_counts = np.array([r.size for r in w.unit_rows], dtype=np.uint32)
    unit_rows = b"".join(r.astype("<u4").tobytes() for r in w.unit_rows)
    flags = 0
    if w.init_plane is not None:
        flags |= _FLAG_INIT
    if w.restart:
        flags |= _FLAG_RESTART
    unit_idx = b""
    if w.unit_idx is not None:
        flags |= _FLAG_DEDUP
        unit_idx = b"".join(i.astype("<u4").tobytes() for i in w.unit_idx)
    sub_hdr = b""
    sub_bulk = None
    if w.raw_mode:
        flags |= _FLAG_RAW
        steps = 0
        bulk = w.payload.tobytes()
        if w.n_units:
            # sub-unit WIRE encoding: dedup S-px spans of the (already
            # unit-deduped) payload; the parser expands back to the
            # canonical [U, 3, 128] so nothing downstream changes.  A
            # record keeps a span's 3 byte-planes together as the dedup
            # key.  Applied pick-smaller below: high-entropy payloads
            # whose spans don't repeat fall back to the plain layout.
            S = _SUBUNIT_S
            k = 128 // S
            pay = w.payload
            sub = pay.reshape(pay.shape[0], 3, k, S).transpose(0, 2, 1, 3)
            sub = np.ascontiguousarray(sub.reshape(-1, 3 * S))
            # u64-hash the records so unique sorts integers, not 24-byte
            # void keys (the void argsort dominated transcode time — the
            # row_index fix applied here); collision guard falls back to
            # the exact lexicographic path
            blob = inv = None
            if (3 * S) % 8 == 0 and sub.size:
                w64 = sub.view(np.uint64).reshape(sub.shape[0],
                                                  3 * S // 8)
                h = np.zeros(sub.shape[0], dtype=np.uint64)
                mult = np.uint64(0x9E3779B97F4A7C15)
                for j in range(w64.shape[1]):
                    h = h * mult + w64[:, j]
                _, first, inv = np.unique(h, return_index=True,
                                          return_inverse=True)
                blob = sub[first]
                if not (blob[inv] == sub).all():
                    blob = inv = None
                elif _subunit_wire_size(blob.shape[0], inv.size,
                                        S) >= len(bulk):
                    # raw-size prefilter, hoisted BEFORE the lex-sort:
                    # same pick-smaller decision as below (sizes are
                    # deterministic), but high-entropy payloads whose
                    # spans don't repeat now skip the sort entirely
                    # (dense-content transcode's hottest line after the
                    # round-5 gather fix)
                    sub = None
                else:
                    # lex-sort just the UNIQUE records (hash order is
                    # effectively random and costs ~2% deflate — similar
                    # spans cluster under lexicographic order).  Byte-
                    # lexicographic == numeric order of the record's
                    # big-endian u64 words, so np.lexsort over 3 integer
                    # columns replaces the 24-byte void argsort (~20x)
                    # with a byte-identical wire
                    bw = np.ascontiguousarray(blob).view(">u8").astype(
                        np.uint64).reshape(-1, 3 * S // 8)
                    order = np.lexsort(tuple(bw[:, j] for j
                                             in range(bw.shape[1] - 1,
                                                      -1, -1)))
                    rank = np.empty(order.size, dtype=np.int64)
                    rank[order] = np.arange(order.size)
                    blob = blob[order]
                    inv = rank[inv]
            if sub is not None:
                if blob is None:
                    view = sub.view([("", np.uint8)] * (3 * S)).reshape(-1)
                    uniq, inv = np.unique(view, return_inverse=True)
                    blob = uniq.view(np.uint8).reshape(-1, 3 * S)
                # ids ride as BYTE PLANES (all lo bytes, then hi bytes,
                # ...): measured 378 -> 300 KB deflated on the terminal
                # corpus vs interleaved u16 (the id stream's lo bytes
                # carry most of the structure; hi bytes are near-constant
                # runs)
                nby_id = 2 if blob.shape[0] <= 0xFFFF else 4
                ids32 = inv.astype(np.uint32)
                sub_bulk = blob.tobytes() + b"".join(
                    ((ids32 >> (8 * j)) & 0xFF).astype(np.uint8).tobytes()
                    for j in range(nby_id))
                sub_hdr = struct.pack("<IB", blob.shape[0], S)
    else:
        steps = w.refills.shape[0]
        bulk = (w.freq.astype("<i4").tobytes()
                + w.states.astype("<u4").tobytes()
                + w.refills.tobytes())
    if w.init_plane is not None:
        bulk += w.init_plane.astype("<u4").tobytes()
    if compress:
        # bulk at level 1: on screen content the win is in the run/repeat
        # structure, not entropy squeezing — higher levels measured much
        # slower for single-digit-% extra shrink (BENCH_NOTES round 4)
        flags |= _FLAG_DEFLATE
        comp = zlib.compress(bulk, 1)
        # raw-size prefilter: when span dedup gained nothing the sub-unit
        # candidate is the same payload bytes plus id arrays — don't pay a
        # level-6 pass over payload-sized data just to discard it (noise
        # windows; the fallback is test-pinned)
        if sub_bulk is not None and len(sub_hdr) + len(sub_bulk) < len(bulk):
            # the id arrays are the sub-unit wire's dominant term and
            # deflate meaningfully better at 6 (378 vs 445 KB terminal);
            # they are small enough that the level-6 cost is one-shot
            comp_sub = zlib.compress(sub_bulk, 6)
            if len(sub_hdr) + len(comp_sub) < len(comp):
                flags |= _FLAG_SUBUNIT
                comp = comp_sub
            else:
                sub_hdr = b""
        else:
            sub_hdr = b""
        bulk = struct.pack("<I", len(comp)) + comp
        # meta at level 6: the block/reference arrays deflate ~4.5x and
        # are small enough that the better ratio is free (BENCH_NOTES
        # round 4; the deflated terminal wire is still payload-dominated)
        flags |= _FLAG_META
        mcomp = zlib.compress(bytes(blocks) + bytes(unit_rows) + unit_idx, 6)
        meta = (unit_counts.astype("<u4").tobytes()
                + struct.pack("<I", len(mcomp)) + mcomp)
    else:
        if sub_bulk is not None and len(sub_hdr) + len(sub_bulk) < len(bulk):
            flags |= _FLAG_SUBUNIT
            bulk = sub_bulk
        else:
            sub_hdr = b""
        meta = (bytes(blocks)
                + unit_counts.astype("<u4").tobytes()
                + bytes(unit_rows)
                + unit_idx)
    body = (struct.pack("<HIIIB", T, w.n_units, n_active, steps, flags)
            + w.changed.astype(np.uint8).tobytes()
            + w.signif.astype(np.uint8).tobytes()
            + w.mvk.astype("<i2").tobytes()
            + n_active_t.astype("<u4").tobytes()
            + meta
            + sub_hdr
            + bulk)
    return struct.pack("<I", len(body)) + body


def container_to_bytes(c: LaneContainer, compress: bool = True) -> bytes:
    import math

    fps_den = 1000
    fps_num = int(round(c.fps * fps_den)) if math.isfinite(c.fps) else 0
    head = struct.pack(_HDR, _MAGIC, c.X, c.Y, c.bpp, c.K, c.n_lanes,
                       c.n_frames, c.window, fps_num, fps_den)
    body = head + b"".join(_window_to_bytes(w, c.K, c.n_lanes,
                                            compress=compress)
                           for w in c.windows)
    if c.audio:
        body += _AUDIO_MAGIC + struct.pack("<Q", len(c.audio)) + c.audio
    return body


def is_lane_container(data: bytes) -> bool:
    return data[:4] == _MAGIC


def container_from_bytes(data: bytes) -> LaneContainer:
    """Parse a container.  Untrusted input: every size field is validated
    against the remaining byte count before allocation (the adversarial-
    stream discipline of the codecs)."""
    hs = struct.calcsize(_HDR)
    if len(data) < hs:
        raise ValueError("lane container truncated (header)")
    magic, X, Y, bpp, K, n_lanes, n_frames, window, fps_num, fps_den = (
        struct.unpack_from(_HDR, data, 0))
    if magic != _MAGIC:
        raise ValueError("not a lane container")
    if not (0 < X <= 1 << 15 and 0 < Y <= 1 << 15 and 0 < n_lanes <= 1 << 15
            and 0 < K <= 8):
        raise ValueError("implausible lane container header")
    c = LaneContainer(X=X, Y=Y, bpp=bpp, K=K, n_lanes=n_lanes,
                      n_frames=n_frames, window=window,
                      fps=(fps_num / fps_den if fps_den else 0.0))
    nbx = (X + 15) // 16
    nby = (Y + 15) // 16
    NB = nbx * nby
    R = Y * (plane_cols(X) // 128)
    off = hs
    while off < len(data):
        if data[off : off + 4] == _AUDIO_MAGIC:
            if off + 12 > len(data):
                raise ValueError("lane container truncated (audio header)")
            (alen,) = struct.unpack_from("<Q", data, off + 4)
            if off + 12 + alen > len(data):
                raise ValueError("lane container truncated (audio)")
            c.audio = bytes(data[off + 12 : off + 12 + alen])
            off += 12 + alen
            continue
        if off + 4 > len(data):
            raise ValueError("lane container truncated (record size)")
        (rec_len,) = struct.unpack_from("<I", data, off)
        off += 4
        end = off + rec_len
        if end > len(data):
            raise ValueError("lane container truncated (record)")
        c.windows.append(_window_from_bytes(
            memoryview(data)[off:end], K, n_lanes, NB, R, X, Y))
        off = end
    # windows tile the timeline exactly; a corrupt T field would otherwise
    # desynchronize every consumer's frame indexing (fuzz-found once window
    # lengths became variable under keyframe-aligned scheduling)
    if sum(w.T for w in c.windows) != n_frames:
        raise ValueError("lane container window lengths do not tile n_frames")
    return c


def _inflate_exact(comp: memoryview, expect: int, what: str) -> bytes:
    """Bounded inflate: adversarial input must not drive an unbounded
    decompression, so the output is capped at (and must equal) the size
    the surrounding fields imply."""
    import zlib

    # reject before allocating: deflate expands at most ~1032:1, so an
    # `expect` beyond that ratio can never check out — without this, a
    # ~25 MB file claiming U near the cap drives a multi-GiB buffer
    # allocation before the exact-size check fails (advisor r4)
    if expect > len(comp) * 1032 + 64:
        raise ValueError(
            f"lane window: deflated {what} claims implausible expansion")
    try:
        dec = zlib.decompressobj()
        # max_length bounds the inflate output (zlib.decompress's bufsize
        # is only an initial hint — a deflate bomb would still expand
        # unboundedly through it).  max_length=0 means UNBOUNDED, so an
        # expected-empty section still caps at 1 byte and fails the exact
        # size check below instead of expanding a bomb in memory
        out = dec.decompress(bytes(comp), expect if expect else 1)
        if dec.unconsumed_tail or dec.decompress(b"", 1):
            raise ValueError(f"lane window: deflated {what} oversized")
    except zlib.error as e:
        raise ValueError(f"lane window: bad deflate {what} ({e})")
    if len(out) != expect:
        raise ValueError(f"lane window: deflated {what} size mismatch")
    return out


def _window_from_bytes(buf: memoryview, K: int, n_lanes: int, NB: int,
                       R: int, X: int, Y: int) -> LaneWindow:
    def take(n):
        nonlocal pos
        if pos + n > len(buf):
            raise ValueError("lane window truncated")
        out = buf[pos : pos + n]
        pos += n
        return out

    pos = struct.calcsize("<HIIIB")
    if len(buf) < pos:
        # fuzz-found: a record shrunk below its fixed header must reject
        # as ValueError like every other truncation, not struct.error
        raise ValueError("lane window truncated (header)")
    T, U, n_active, steps, flags = struct.unpack_from("<HIIIB", buf, 0)
    if T == 0 or T > 1 << 12 or U > 1 << 26 or n_active > (1 << 12) * NB \
            or steps > 1 << 24 or flags > 127 or U > T * R:
        # U > T*R can never be referenced (units are per-frame plane rows,
        # strictly increasing and < R), so a crafted header claiming more
        # is rejected before it can size any allocation (advisor r4)
        # T == 0 would silently reset chained carries (the serializer
        # never emits empty windows; fuzz/review-found)
        raise ValueError("implausible lane window header")
    has_init = flags & _FLAG_INIT
    raw_mode = bool(flags & _FLAG_RAW)
    if raw_mode and has_init:
        raise ValueError("lane window: raw payload excludes init planes")
    subunit = bool(flags & _FLAG_SUBUNIT)
    if subunit and not raw_mode:
        raise ValueError("lane window: sub-unit payload requires raw mode")
    changed = np.frombuffer(take(T), dtype=np.uint8).astype(bool)
    signif = np.frombuffer(take(T), dtype=np.uint8).astype(bool)
    mvk = np.frombuffer(take(T * K * 2 * 2), dtype="<i2").astype(
        np.int32).reshape(T, K, 2)
    n_active_t = np.frombuffer(take(T * 4), dtype="<u4").astype(np.int64)
    if int(n_active_t.sum()) != n_active:
        raise ValueError("lane window: active-block counts disagree")
    dedup = bool(flags & _FLAG_DEDUP)

    def check_refs(unit_counts):
        n_refs = int(unit_counts.sum())
        if n_refs > 1 << 26:
            raise ValueError("lane window: implausible reference count")
        if not dedup and n_refs != U:
            raise ValueError("lane window: unit counts disagree")
        if dedup and U > n_refs:
            raise ValueError(
                "lane window: more payload units than references")
        return n_refs

    if flags & _FLAG_META:
        # meta-deflated layout: reference counts first (they size the
        # inflate bound), then one zlib stream of blocks | rows | [idx]
        unit_counts = np.frombuffer(take(T * 4), dtype="<u4").astype(
            np.int64)
        n_refs = check_refs(unit_counts)
        if pos + 4 > len(buf):
            raise ValueError("lane window truncated")
        (mclen,) = struct.unpack_from("<I", buf, pos)
        pos += 4
        expect_m = n_active * 9 + n_refs * 4 * (2 if dedup else 1)
        mb = memoryview(_inflate_exact(take(mclen), expect_m, "meta"))
        rec = np.frombuffer(mb[: n_active * 9],
                            dtype=np.uint8).reshape(-1, 9)
        mo = n_active * 9
        rows_all = np.frombuffer(mb[mo : mo + n_refs * 4],
                                 dtype="<u4").astype(np.int64)
        mo += n_refs * 4
        idx_all = (np.frombuffer(mb[mo : mo + n_refs * 4],
                                 dtype="<u4").astype(np.int64)
                   if dedup else None)
    else:
        rec = np.frombuffer(take(n_active * 9),
                            dtype=np.uint8).reshape(-1, 9)
        unit_counts = np.frombuffer(take(T * 4), dtype="<u4").astype(
            np.int64)
        n_refs = check_refs(unit_counts)
        rows_all = np.frombuffer(take(n_refs * 4),
                                 dtype="<u4").astype(np.int64)
        idx_all = (np.frombuffer(take(n_refs * 4),
                                 dtype="<u4").astype(np.int64)
                   if dedup else None)

    bi_all = rec[:, 0:4].copy().view("<u4").reshape(-1).astype(np.int64)
    if (bi_all >= NB).any():
        raise ValueError("lane window: block index out of range")
    btype = np.zeros((T, NB), dtype=np.uint8)
    rect = np.zeros((T, NB, 4), dtype=np.uint8)
    o = 0
    for t in range(T):
        n = int(n_active_t[t])
        bi = bi_all[o : o + n]
        btype[t, bi] = rec[o : o + n, 4]
        rect[t, bi] = rec[o : o + n, 5:9]
        o += n
    bt_bad = (btype > 1 + K)  # valid codes 0..K+1 (motion slots 0..K-1)
    if bt_bad.any():
        raise ValueError("lane window: block type out of range")
    # rects are within-cell coords (0..16); a rect spilling past its own
    # 16x16 block would make decode output depend on block-application
    # order (host fast path applies full cells before partial rects)
    if (rec[:, 5:9] > 16).any():
        raise ValueError("lane window: block rect out of range")
    if (rows_all >= R).any():
        raise ValueError("lane window: unit row out of range")
    if idx_all is not None and n_refs and (idx_all >= U).any():
        raise ValueError("lane window: unit index out of range")
    unit_rows = []
    unit_idx = [] if dedup else None
    o = 0
    for t in range(T):
        n = int(unit_counts[t])
        rows = rows_all[o : o + n]
        if n and (np.diff(rows) <= 0).any():
            raise ValueError("lane window: unit rows not strictly increasing")
        unit_rows.append(rows)
        if dedup:
            unit_idx.append(idx_all[o : o + n])
        o += n
    Us = Sw = kw = idw = 0
    if subunit:
        # sub-unit payload header (uncompressed — it sizes the inflate
        # bound): u32 span count | u8 span width
        if pos + 5 > len(buf):
            raise ValueError("lane window truncated")
        Us, Sw = struct.unpack_from("<IB", buf, pos)
        pos += 5
        if Sw not in (1, 2, 4, 8, 16, 32, 64):
            raise ValueError("lane window: bad sub-unit width")
        kw = 128 // Sw
        if Us > U * kw:
            raise ValueError("lane window: more sub-units than spans")
        idw = 2 if Us <= 0xFFFF else 4
    if flags & _FLAG_DEFLATE:
        if pos + 4 > len(buf):
            raise ValueError("lane window truncated")
        (clen,) = struct.unpack_from("<I", buf, pos)
        pos += 4
        if raw_mode:
            expect = (Us * 3 * Sw + U * kw * idw if subunit
                      else 3 * U * 128)
        else:
            expect = 256 * 4 + n_lanes * 4 + steps * n_lanes * 2
        expect += X * Y * 4 if has_init else 0
        buf = memoryview(_inflate_exact(take(clen), expect, "bulk"))
        pos = 0
    freq = states = refills = payload = None
    if raw_mode:
        if subunit:
            blob = np.frombuffer(take(Us * 3 * Sw), dtype=np.uint8)
            blob = blob.reshape(Us, 3 * Sw)
            # ids are byte planes (lo bytes first — see serializer)
            raw = np.frombuffer(take(U * kw * idw),
                                dtype=np.uint8).reshape(idw, U * kw)
            ids = np.zeros(U * kw, dtype=np.uint32)
            for j in range(idw):
                ids |= raw[j].astype(np.uint32) << (8 * j)
            if ids.size and (Us == 0 or (ids >= Us).any()):
                raise ValueError("lane window: sub-unit index out of range")
            payload = (blob[ids.astype(np.int64)]
                       .reshape(U, kw, 3, Sw).transpose(0, 2, 1, 3)
                       .reshape(U, 3, 128).copy())
        else:
            payload = np.frombuffer(take(3 * U * 128), dtype=np.uint8)
            payload = payload.reshape(U, 3, 128).copy()
    else:
        freq = np.frombuffer(take(256 * 4), dtype="<i4").astype(np.int32)
        if int(freq.sum()) != rans_lanes.PROB_SCALE or (freq <= 0).any():
            raise ValueError("lane window: invalid frequency table")
        states = np.frombuffer(take(n_lanes * 4), dtype="<u4").astype(
            np.uint32)
        refills = np.frombuffer(take(steps * n_lanes * 2), dtype=np.uint8)
        refills = refills.reshape(steps, n_lanes, 2).copy()
        if 3 * U * 128 > steps * n_lanes:
            raise ValueError("lane window: payload exceeds lane capacity")
    init_plane = None
    if has_init:
        init_plane = np.frombuffer(take(X * Y * 4), dtype="<u4").astype(
            np.uint32).reshape(Y, X)
    # the restart flag is a decode-semantics statement ("carry-independent:
    # frame 0 fully paints"), and the host honors it (zero entry carry,
    # lane_host.window_entry_carry) while the device compose always chains —
    # for genuine containers the two are indistinguishable BECAUSE the flag
    # matches the content.  A flag that lies (fuzz-found, seed 904619)
    # diverges the two paths, so re-derive the predicate from the parsed
    # commands and reject a mismatch (same test as derive_window's, on the
    # wire's block-local rects).
    claimed_restart = bool(flags & _FLAG_RESTART)
    if has_init:
        # rans-mode restart: frame 0 was extracted into the init plane and
        # rides as an all-copy changed frame (derive_window's t==0 skip)
        content_restart = bool(T > 0 and changed[0] and not n_active_t[0])
    else:
        nbx = (X + 15) // 16
        nby = (Y + 15) // 16
        full_loc = _block_local_rects(block_full_rects(X, Y, nbx, nby), nbx)
        content_restart = bool(T > 0 and changed[0]
                               and (btype[0] == 1).all()
                               and (rect[0] == full_loc).all())
    if claimed_restart != content_restart:
        raise ValueError("lane window: restart flag contradicts content")
    if has_init and not claimed_restart:
        raise ValueError("lane window: init plane on a non-restart window")
    return LaneWindow(T=T, changed=changed, signif=signif, mvk=mvk,
                      btype=btype, rect=rect, unit_rows=unit_rows,
                      unit_idx=unit_idx, n_units=U, freq=freq,
                      states=states, refills=refills,
                      init_plane=init_plane, payload=payload,
                      restart=claimed_restart)

"""Lane-entropy-coded tile payloads on torch: the kmv_sparse path's tile
bytes, rANS-coded on the host and decoded on the card.

Counterpart of jsplayer_tpu/kernels/lane_transport.py.  The sparse kmv
transport ships final-content 16x16 tiles; here their pixel bytes (3 a
word, little-endian: the top byte is transport metadata) are coded with the
multi-lane rANS of kernels/rans_lanes, so the payload crosses the
host→device link compressed and is entropy-decoded on the device.  Two wire
layouts, as in the reference: ``packed`` (each lane's own byte row,
``rans_decode_packed`` of csrc/rans_lanes.cu) and ``aligned`` (the
pre-simulated refill schedule, ``rans_decode_aligned``).  No kernel of its
own: ``_syms_to_tiles`` is the byte combine, torch ops as the lane path's
units_from_raw.

``LanePack``, ``_pick_lanes``, ``_bucket_steps``, ``pack_to_bytes`` and
``pack_from_bytes`` are verbatim copies of the reference's (its module
imports jax at the top, which this package never does), and so is
``encode_tiles`` but for one line: it calls ``encode_lanes_lockstep``, the
reference's rans_lanes.encode_lanes run over all lanes at once in numpy
(the same bytes and states; the reference's loop takes the symbols one at
a time in Python, far too slow for a 1080p window's tiles).  tests/test_torch_lane_transport.py
pins each copy by its source text and its outputs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from . import rans_lanes
from ..device import resolve_device, to_device


def _pick_lanes(n_bytes: int) -> int:
    """Lane count: enough parallel width to keep the VPU busy, small enough
    that short payloads don't drown in padding."""
    if n_bytes >= 1 << 20:
        return 2048
    if n_bytes >= 1 << 16:
        return 512
    return 128


def _bucket_steps(n: int) -> int:
    """Round scan lengths to powers of two — bounds jit recompiles."""
    b = 1
    while b < n:
        b <<= 1
    return b


@dataclass
class LanePack:
    """One window's entropy-coded tile payload."""

    n_tiles: int                    # S — rows of the [S, 256] tile array
    n_lanes: int
    freq: np.ndarray                # [256] i32 static table
    init_states: np.ndarray         # [N] u32
    lane_bytes: Optional[np.ndarray] = None   # [N, L] u8 (packed layout)
    refills: Optional[np.ndarray] = None      # [steps, N, 2] u8 (aligned)

    @property
    def n_symbols(self) -> int:
        return self.n_tiles * 256 * 3

    def wire_bytes(self) -> int:
        """Payload size crossing the link (excluding the small table/state)."""
        if self.refills is not None:
            return int(self.refills.size)
        return int(self.lane_bytes.size)


def encode_tiles(flat_tiles: np.ndarray, layout: str = "packed",
                 n_lanes: Optional[int] = None) -> LanePack:
    """[S, 256] u32 tile rows → LanePack (host side)."""
    S = int(flat_tiles.shape[0])
    u32 = np.ascontiguousarray(flat_tiles.reshape(-1), dtype=np.uint32)
    b = np.empty((u32.size, 3), dtype=np.uint8)
    b[:, 0] = u32 & 0xFF
    b[:, 1] = (u32 >> 8) & 0xFF
    b[:, 2] = (u32 >> 16) & 0xFF
    syms = b.reshape(-1)
    if n_lanes is None:
        n_lanes = _pick_lanes(syms.size)
    freq = rans_lanes.build_freq_table(syms)
    lane_bytes, states, ns = encode_lanes_lockstep(syms, freq, n_lanes)
    pack = LanePack(S, n_lanes, freq, states, lane_bytes=lane_bytes)
    if layout == "aligned":
        n_steps = _bucket_steps(-(-ns // n_lanes))
        pack.refills = rans_lanes.layout_refills(lane_bytes, states, freq,
                                                 n_steps)
        pack.lane_bytes = None
    return pack


def encode_lanes_lockstep(symbols: np.ndarray, freq: np.ndarray,
                          n_lanes: int) -> tuple[np.ndarray, np.ndarray, int]:
    """rans_lanes.encode_lanes with every lane advanced together: the same
    (lane_bytes u8 [N, L] zero-padded, init_states u32 [N], n_symbols).
    Lane j encodes symbols j, j+N, j+2N, ... from the last one down; a step
    encodes one symbol in each lane that still has one (every lane but the
    short ones of the last row), emitting at most two renormalisation bytes
    a lane (x < 2^31 and x_max >= 2^19), which each lane then reverses."""
    n = len(symbols)
    N = int(n_lanes)
    freq64 = np.asarray(freq, dtype=np.uint64)
    cum = np.zeros(len(freq) + 1, dtype=np.uint64)
    cum[1:] = np.cumsum(freq64)
    rows = -(-n // N)
    sym = np.zeros(rows * N, dtype=np.int64)
    sym[:n] = symbols
    sym = sym.reshape(rows, N)
    x = np.full(N, rans_lanes.RANS_L, dtype=np.uint64)
    out = np.zeros((2 * rows, N), dtype=np.uint8)
    cnt = np.zeros(N, dtype=np.int64)
    lanes = np.arange(N)
    shift = np.uint64(rans_lanes.PROB_BITS)
    for r in range(rows - 1, -1, -1):
        act = r * N + lanes < n
        s = sym[r]
        f = freq64[s]
        x_max = np.uint64((rans_lanes.RANS_L >> rans_lanes.PROB_BITS) << 8) * f
        for _ in range(2):
            emit = act & (x >= x_max)
            out[cnt[emit], lanes[emit]] = (x[emit] & np.uint64(0xFF))
            cnt += emit
            x = np.where(emit, x >> np.uint64(8), x)
        enc = ((x // f) << shift) + (x % f) + cum[s]
        x = np.where(act, enc, x)
    L = int(cnt.max(initial=0))
    lane_bytes = np.zeros((N, L), dtype=np.uint8)
    for j in np.nonzero(cnt)[0]:
        lane_bytes[j, : cnt[j]] = out[cnt[j] - 1:: -1, j][: cnt[j]]
    return lane_bytes, x.astype(np.uint32), n


def _syms_to_tiles(syms: torch.Tensor, S: int) -> torch.Tensor:
    """[steps, N] u8 interleaved symbols → [S, 256] int32 tiles (u32 bits):
    byte0 | byte1 << 8 | byte2 << 16."""
    b = syms.reshape(-1)[: S * 256 * 3].to(torch.int32).reshape(S, 256, 3)
    return b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16)


def decode_tiles_device(pack: LanePack, device="cuda") -> torch.Tensor:
    """LanePack → [S, 256] int32 tiles on `device`, the entropy decode on
    the device: rans_decode_aligned for the aligned layout, else
    rans_decode_packed (csrc/rans_lanes.cu on the card, their plain twins
    on the CPU)."""
    dev = resolve_device(device)
    if pack.n_tiles == 0:
        return torch.zeros((0, 256), dtype=torch.int32, device=dev)
    freq = to_device(np.asarray(pack.freq, dtype=np.int32), dev)
    states = to_device(np.asarray(pack.init_states, dtype=np.uint32), dev)
    if pack.refills is not None:
        syms = rans_lanes.decode_lanes_aligned(
            to_device(pack.refills, dev), states, freq)
    else:
        n_steps = _bucket_steps(-(-pack.n_symbols // pack.n_lanes))
        syms = rans_lanes.decode_lanes(
            to_device(pack.lane_bytes, dev), states, freq, n_steps)
    return _syms_to_tiles(syms, pack.n_tiles)


# ---------------------------------------------------------------------------
# Serialization — the persistent "re-encoded" artifact (lane-pack container)
# ---------------------------------------------------------------------------

_MAGIC = b"JTLP"


def pack_to_bytes(pack: LanePack) -> bytes:
    """Serialize for storage/wire.  Layout: magic, header ints, freq table,
    states, payload (refills or lane rows)."""
    import struct

    aligned = pack.refills is not None
    payload = (pack.refills if aligned else pack.lane_bytes)
    head = struct.pack(
        "<4sBIII", _MAGIC, 1 if aligned else 0, pack.n_tiles, pack.n_lanes,
        payload.shape[0] if aligned else payload.shape[1])
    return (head + pack.freq.astype("<i4").tobytes()
            + pack.init_states.astype("<u4").tobytes()
            + payload.tobytes())


def pack_from_bytes(data: bytes) -> LanePack:
    """Parse a serialized pack.  Untrusted input: every size field is
    validated against the actual payload length before any allocation, so
    a malformed blob raises ValueError instead of allocating gigabytes or
    over-reading (same adversarial-stream discipline as the codecs)."""
    import struct

    head_sz = struct.calcsize("<4sBIII")
    if len(data) < head_sz:
        raise ValueError("lane pack truncated (header)")
    magic, aligned, S, N, dim = struct.unpack_from("<4sBIII", data, 0)
    if magic != _MAGIC:
        raise ValueError("not a lane pack")
    if not (0 < N <= 1 << 16) or S > 1 << 24 or dim > 1 << 28:
        raise ValueError(f"implausible lane pack header S={S} N={N} d={dim}")
    payload = (dim * N * 2) if aligned else (N * dim)
    need = head_sz + 256 * 4 + N * 4 + payload
    if len(data) < need:
        raise ValueError(f"lane pack truncated ({len(data)} < {need})")
    off = head_sz
    freq = np.frombuffer(data, dtype="<i4", count=256, offset=off).copy()
    off += 256 * 4
    states = np.frombuffer(data, dtype="<u4", count=N, offset=off).copy()
    off += N * 4
    if aligned:
        refills = np.frombuffer(data, dtype=np.uint8, count=dim * N * 2,
                                offset=off).reshape(dim, N, 2).copy()
        return LanePack(S, N, freq, states, refills=refills)
    lane_bytes = np.frombuffer(data, dtype=np.uint8, count=N * dim,
                               offset=off).reshape(N, dim).copy()
    return LanePack(S, N, freq, states, lane_bytes=lane_bytes)

"""Interleaved multi-lane rANS on torch: the lane container's entropy decode.

Counterpart of jsplayer_tpu/kernels/rans_lanes.py.  Symbols are spread
round-robin over N independent rANS lanes with a static 12-bit frequency
table (L = 2^23 renormalisation, at most two byte refills a step), so all
N states advance in lockstep.  Two layouts, as in the reference:

  * renorm-aligned (``rans_decode_aligned``): the host pre-lays each
    step's refill bytes (``layout_refills``), refills [steps, N, 2];
  * packed (``rans_decode_packed``): each lane reads its own byte row at
    its own cursor, lane_bytes [N, L]; a read past a lane's last byte
    takes 255, as the reference's ``take_along_axis`` fill does.

Each is one launch for B streams of csrc/rans_lanes.cu for tensors on the
card (one thread a lane, the state in a register, 4096-slot tables in
shared memory, the refill bytes copied into shared memory far ahead of
the lane's dependent chain; the aligned decode's other shapes take an
instance of byte loads, ``ALIGNED_INSTANCES``), and its plain twin
``*_ref`` (int64 torch ops masked to 32 bits) for tensors on the CPU.  The
reference's functions keep their names and signatures
(``decode_lanes_aligned``, ``decode_lanes``, ``roundtrip_decode``,
``roundtrip_decode_aligned``) as B=1 calls of those.

u32 words (states) are int32 tensors holding the u32 bits (device.py);
refills, lane bytes and symbols are uint8, freq int32.  The kernels assume
a frequency table the lane container's parser admits: every entry > 0
and the sum exactly PROB_SCALE (lane_format rejects any other).  The
twins follow the reference's arithmetic for such tables.

The numpy host helpers (PROB_BITS .. layout_refills) are verbatim copies of
the reference's: its module imports jax at the top, which this package
never does.  tests/test_torch_rans_lanes.py pins each one.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from .. import _build
from ..device import resolve_device, to_device

PROB_BITS = 12
PROB_SCALE = 1 << PROB_BITS
RANS_L = 1 << 23


def build_freq_table(symbols: np.ndarray, nsym: int = 256) -> np.ndarray:
    """Static per-chunk frequency table summing to PROB_SCALE, every symbol
    given at least 1 slot (so any byte remains decodable)."""
    hist = np.bincount(symbols, minlength=nsym).astype(np.float64)
    freq = np.maximum(1, np.round(hist / max(1, hist.sum()) * (PROB_SCALE - nsym))
                      ).astype(np.int64)
    # exact normalization: trim/boost the most frequent symbols
    while freq.sum() > PROB_SCALE:
        i = int(np.argmax(freq))
        freq[i] -= min(freq[i] - 1, freq.sum() - PROB_SCALE)
    freq[int(np.argmax(freq))] += PROB_SCALE - freq.sum()
    assert freq.sum() == PROB_SCALE and (freq > 0).all()
    return freq.astype(np.int32)


def encode_lanes(symbols: np.ndarray, freq: np.ndarray, n_lanes: int
                 ) -> tuple[np.ndarray, np.ndarray, int]:
    """Encode symbols round-robin over n_lanes reverse-order rANS encoders.

    → (lane_bytes u8 [N, L] zero-padded, init_states u32 [N], n_symbols).
    Lane j owns symbols j, j+N, j+2N, ... (interleaved layout: adjacent
    symbols decode in the same lockstep step across lanes)."""
    cum = np.zeros(len(freq) + 1, dtype=np.int64)
    cum[1:] = np.cumsum(freq)
    n = len(symbols)
    lanes_out: list[bytearray] = [bytearray() for _ in range(n_lanes)]
    states = np.zeros(n_lanes, dtype=np.uint64)
    for j in range(n_lanes):
        x = RANS_L
        out = lanes_out[j]
        for idx in range(((n - 1 - j) // n_lanes) * n_lanes + j, -1, -n_lanes):
            s = int(symbols[idx])
            f = int(freq[s])
            x_max = ((RANS_L >> PROB_BITS) << 8) * f
            while x >= x_max:
                out.append(x & 0xFF)
                x >>= 8
            x = ((x // f) << PROB_BITS) + (x % f) + int(cum[s])
        out.reverse()
        states[j] = x
    L = max((len(o) for o in lanes_out), default=0)
    lane_bytes = np.zeros((n_lanes, L), dtype=np.uint8)
    for j, o in enumerate(lanes_out):
        lane_bytes[j, : len(o)] = np.frombuffer(bytes(o), dtype=np.uint8)
    return lane_bytes, states.astype(np.uint32), n


def layout_refills(lane_bytes: np.ndarray, init_states: np.ndarray,
                   freq: np.ndarray, n_steps: int) -> np.ndarray:
    """Re-layout lane bytes into the REFILL SCHEDULE [n_steps, N, 2] u8.

    The rANS refill pattern is a deterministic function of the stream, so
    the host (or the encoder itself) can pre-simulate the decode and place
    each step's refill bytes in a dense row.  The device scan then consumes
    them as scan inputs — contiguous [N, 2]-byte reads per step — instead
    of per-lane ``take_along_axis`` gathers at divergent positions, which
    were the measured bottleneck (~26 Msym/s, latency-bound).  Unused slots
    are 0 (the decoder's ``need`` masks skip them in lockstep with this
    simulation).  Cost: a fixed ~2 B/lane/step shipped regardless of
    entropy — cheap vs ~1 B/sym incompressible data, up to ~10-20x on
    highly compressible screen content (codecs/lane_format size note);
    the buy is gather-free decode at Gsym/s.
    """
    cum = np.zeros(257, dtype=np.uint64)
    cum[1:] = np.cumsum(freq.astype(np.uint64))
    n_lanes = lane_bytes.shape[0]
    x = init_states.astype(np.uint64)
    pos = np.zeros(n_lanes, dtype=np.int64)
    lanes = np.arange(n_lanes)
    refills = np.zeros((n_steps, n_lanes, 2), dtype=np.uint8)
    L = lane_bytes.shape[1]
    freq_u = freq.astype(np.uint64)
    for s in range(n_steps):
        sf = x & np.uint64(PROB_SCALE - 1)
        sym = np.searchsorted(cum[1:257], sf, side="right")
        x = freq_u[sym] * (x >> np.uint64(PROB_BITS)) + sf - cum[sym]
        for k in range(2):
            need = x < RANS_L
            if L == 0:  # zero-payload window: nothing to refill from
                b = np.zeros(n_lanes, dtype=np.uint64)
            else:
                b = np.where(need & (pos < L),
                             lane_bytes[lanes, np.minimum(pos, L - 1)],
                             0).astype(np.uint64)
            refills[s, :, k] = np.where(need, b, 0)
            x = np.where(need, (x << np.uint64(8)) | b, x)
            pos = pos + need
    return refills


# ---------------------------------------------------------------------------
# The decode step, as plain torch ops (the twins)
# ---------------------------------------------------------------------------

_MASK32 = 0xFFFFFFFF


def _tables(freq: torch.Tensor):
    """freq [B, 256] → (freq, exclusive cumfreq) [B, 256] int64."""
    f = freq.to(torch.int64)
    return f, torch.cumsum(f, dim=1) - f


def _decode_symbol(x, f, cum):
    """One lockstep step's symbol and state update for states x [B, N]
    (int64 holding u32): the symbol is the last s with cumfreq[s] <= the
    slot x & 4095 (the reference's compare-and-count), then x = f * (x >>
    12) + slot - c, wrapped to 32 bits."""
    slot = x & (PROB_SCALE - 1)
    sym = torch.searchsorted(cum, slot, right=True) - 1
    fs, cs = torch.gather(f, 1, sym), torch.gather(cum, 1, sym)
    return sym, (fs * (x >> PROB_BITS) + slot - cs) & _MASK32


def _refill(x, byte):
    """One refill: x < RANS_L (unsigned) takes the byte."""
    need = x < RANS_L
    return torch.where(need, ((x << 8) | byte) & _MASK32, x), need


def rans_decode_aligned_ref(refills: torch.Tensor, states: torch.Tensor,
                            freq: torch.Tensor) -> torch.Tensor:
    """Plain twin of rans_decode_aligned: refills [B, steps, N, 2] uint8,
    states [B, N] int32 (u32 bits), freq [B, 256] int32 → symbols [B, steps,
    N] uint8."""
    B, steps, N, _ = refills.shape
    f, cum = _tables(freq)
    x = states.to(torch.int64) & _MASK32
    r = refills.to(torch.int64)
    out = torch.empty((B, steps, N), dtype=torch.uint8, device=refills.device)
    for t in range(steps):
        sym, x = _decode_symbol(x, f, cum)
        out[:, t] = sym.to(torch.uint8)
        x, _ = _refill(x, r[:, t, :, 0])
        x, _ = _refill(x, r[:, t, :, 1])
    return out


def rans_decode_packed_ref(lane_bytes: torch.Tensor, states: torch.Tensor,
                           freq: torch.Tensor, n_steps: int,
                           cursors: bool = False):
    """Plain twin of rans_decode_packed: lane_bytes [B, N, L] uint8, states
    [B, N] int32 (u32 bits), freq [B, 256] int32 → symbols [B, n_steps, N]
    uint8 (and, with `cursors`, each lane's final byte cursor [B, N] int64:
    the bytes it consumed are min(cursor, L)).  A refill past a lane's last
    byte takes 255, and 0 where L == 0 (the reference's gathers read so)."""
    B, N, L = lane_bytes.shape
    f, cum = _tables(freq)
    x = states.to(torch.int64) & _MASK32
    lb = lane_bytes.to(torch.int64)
    pos = torch.zeros((B, N), dtype=torch.int64, device=lane_bytes.device)
    out = torch.empty((B, n_steps, N), dtype=torch.uint8,
                      device=lane_bytes.device)
    for t in range(n_steps):
        sym, x = _decode_symbol(x, f, cum)
        out[:, t] = sym.to(torch.uint8)
        for _ in range(2):
            if L:
                got = torch.gather(lb, 2, pos.clamp(max=L - 1)[..., None])[..., 0]
                byte = torch.where(pos < L, got, 255)
            else:  # no byte to read: the reference's gather reads 0
                byte = torch.zeros_like(x)
            x, need = _refill(x, byte)
            pos = pos + need.to(torch.int64)
    return (out, pos) if cursors else out


# ---------------------------------------------------------------------------
# The kernels (csrc/rans_lanes.cu)
# ---------------------------------------------------------------------------

def _check_cuda(what: str, args) -> torch.device:
    """A wrapper's guard for its non-CPU branch: every (name, tensor,
    dtype) lies on one CUDA device with its dtype.  Anything else raises:
    a tensor not on the CPU never takes the plain twin."""
    dev = args[0][1].device
    for name, t, dtype in args:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(
                f"{what}: expected tensors on one CUDA device (or all on "
                f"the CPU for the plain version), got {name} on {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"{what}: {name} must be {dtype}, got {t.dtype}")
    return dev


def _check_tables(what: str, states, freq, B: int, N: int) -> None:
    if tuple(states.shape) != (B, N) or (N and states.stride(1) != 1):
        raise ValueError(f"{what}: states must be [{B}, {N}] with "
                         f"contiguous rows, got {tuple(states.shape)}")
    if tuple(freq.shape) != (B, 256) or freq.stride(1) != 1:
        raise ValueError(f"{what}: freq must be [{B}, 256] with contiguous "
                         f"rows, got {tuple(freq.shape)}")


def rans_decode_aligned(refills: torch.Tensor, states: torch.Tensor,
                        freq: torch.Tensor) -> torch.Tensor:
    """The renorm-aligned lockstep decode of B streams: refills [B, steps,
    N, 2] uint8 (each stream's [steps, N, 2] contiguous), states [B, N]
    int32 (u32 bits), freq [B, 256] int32, each row > 0 and summing to
    PROB_SCALE → symbols [B, steps, N] uint8.

    CUDA kernel csrc/rans_lanes.cu (aligned mode) for tensors on the card,
    one launch for all B; the plain twin only for tensors on the CPU.  It
    replaces the reference's decode_lanes_aligned (rans_lanes.py:195), whose
    two-level one-hot matmul search existed for the TPU's MXU."""
    if refills.device.type == "cpu":
        return rans_decode_aligned_ref(refills, states, freq)
    what = "rans_decode_aligned"
    dev = _check_cuda(what, [("refills", refills, torch.uint8),
                             ("states", states, torch.int32),
                             ("freq", freq, torch.int32)])
    if refills.dim() != 4 or refills.shape[-1] != 2:
        raise ValueError(f"{what}: refills must be [B, steps, N, 2], got "
                         f"{tuple(refills.shape)}")
    B, steps, N, _ = refills.shape
    if B and not refills[0].is_contiguous():
        raise ValueError(f"{what}: each stream's refills must be a "
                         f"contiguous [steps, N, 2]")
    _check_tables(what, states, freq, B, N)
    out = torch.empty((B, steps, N), dtype=torch.uint8, device=dev)
    if B and steps and N:
        lib = _build.load()
        args = (refills.data_ptr(), refills.stride(0))
        instance = ALIGNED_INSTANCES[lib.jsp_rans_aligned_instance(*args, N)]
        with torch.cuda.device(dev):
            rc = lib.jsp_rans_decode_aligned(
                *args, states.data_ptr(), states.stride(0), freq.data_ptr(),
                freq.stride(0), out.data_ptr(), out.stride(0), B, N, steps,
                torch.cuda.current_stream(dev).cuda_stream)
        _build.check(rc, what)
        rans_decode_aligned.launches += 1
        rans_decode_aligned.by_instance[instance] += 1
        rans_decode_aligned.last_instance = instance
    return out


#: the aligned kernel's instances, by jsp_rans_aligned_instance's answer:
#: refills staged in shared memory (16-byte aligned refills and batch
#: stride, N % 8 == 0), or byte loads from device memory
ALIGNED_INSTANCES = ("bytes", "staged")
rans_decode_aligned.launches = 0  # kernel launches (the plain path does not count)
# the launches per instance, and the instance of the last one
rans_decode_aligned.by_instance = collections.Counter()
rans_decode_aligned.last_instance = None


def rans_decode_packed(lane_bytes: torch.Tensor, states: torch.Tensor,
                       freq: torch.Tensor, n_steps: int) -> torch.Tensor:
    """The packed lockstep decode of B streams, each lane at its own byte
    cursor: lane_bytes [B, N, L] uint8 (each stream's [N, L] contiguous),
    states [B, N] int32 (u32 bits), freq [B, 256] int32 as for
    rans_decode_aligned → symbols [B, n_steps, N] uint8.  A refill past a
    lane's last byte takes 255 (0 where L == 0).

    CUDA kernel csrc/rans_lanes.cu (packed mode) for tensors on the card,
    one launch for all B; the plain twin only for tensors on the CPU.  It
    replaces the reference's decode_lanes (rans_lanes.py:102)."""
    if lane_bytes.device.type == "cpu":
        return rans_decode_packed_ref(lane_bytes, states, freq, n_steps)
    what = "rans_decode_packed"
    dev = _check_cuda(what, [("lane_bytes", lane_bytes, torch.uint8),
                             ("states", states, torch.int32),
                             ("freq", freq, torch.int32)])
    if lane_bytes.dim() != 3:
        raise ValueError(f"{what}: lane_bytes must be [B, N, L], got "
                         f"{tuple(lane_bytes.shape)}")
    B, N, L = lane_bytes.shape
    if B and not lane_bytes[0].is_contiguous():
        raise ValueError(f"{what}: each stream's lane_bytes must be a "
                         f"contiguous [N, L]")
    if L > 2**31 - 64:  # the kernel's byte positions in a row are int
        raise ValueError(f"{what}: lanes of {L} bytes are too long")
    _check_tables(what, states, freq, B, N)
    out = torch.empty((B, n_steps, N), dtype=torch.uint8, device=dev)
    if B and n_steps and N:
        lib = _build.load()
        with torch.cuda.device(dev):
            rc = lib.jsp_rans_decode_packed(
                lane_bytes.data_ptr(), lane_bytes.stride(0), L,
                states.data_ptr(), states.stride(0), freq.data_ptr(),
                freq.stride(0), out.data_ptr(), out.stride(0), B, N, n_steps,
                torch.cuda.current_stream(dev).cuda_stream)
        _build.check(rc, what)
        rans_decode_packed.launches += 1
    return out


rans_decode_packed.launches = 0  # kernel launches (the plain path does not count)


# ---------------------------------------------------------------------------
# The reference's signatures (one stream)
# ---------------------------------------------------------------------------

def decode_lanes_aligned(refills: torch.Tensor, init_states: torch.Tensor,
                         freq: torch.Tensor) -> torch.Tensor:
    """refills [n_steps, N, 2] uint8, init_states [N] (u32 bits), freq [256]
    → symbols [n_steps, N] uint8."""
    return rans_decode_aligned(refills[None], init_states[None],
                               freq[None])[0]


def decode_lanes(lane_bytes: torch.Tensor, init_states: torch.Tensor,
                 freq: torch.Tensor, n_steps: int) -> torch.Tensor:
    """Lockstep decode: lane_bytes [N, L] uint8, init_states [N], freq
    [256] → symbols [n_steps, N] uint8 (interleaved layout; flatten + trim
    to recover the original order)."""
    return rans_decode_packed(lane_bytes[None], init_states[None],
                              freq[None], n_steps)[0]


def _put_tables(init_states, freq, device):
    dev = resolve_device(device)
    return (dev, to_device(np.asarray(init_states, dtype=np.uint32), dev),
            to_device(np.asarray(freq, dtype=np.int32), dev))


def roundtrip_decode(lane_bytes, init_states, freq, n_symbols, n_lanes,
                     device="cuda") -> np.ndarray:
    """Host helper: device decode + trim to the original order.  Position
    (step s, lane j) holds symbol s*N + j, so the row-major flatten of the
    [steps, N] lockstep output IS the original order."""
    n_steps = -(-n_symbols // n_lanes)
    dev, st, fq = _put_tables(init_states, freq, device)
    syms = decode_lanes(to_device(np.asarray(lane_bytes, dtype=np.uint8),
                                  dev), st, fq, n_steps)
    return syms.cpu().numpy().reshape(-1)[:n_symbols]


def roundtrip_decode_aligned(lane_bytes, init_states, freq, n_symbols,
                             n_lanes, device="cuda") -> np.ndarray:
    """Host helper: aligned re-layout + gather-free device decode + trim."""
    n_steps = -(-n_symbols // n_lanes)
    refills = layout_refills(np.asarray(lane_bytes), np.asarray(init_states),
                             np.asarray(freq), n_steps)
    dev, st, fq = _put_tables(init_states, freq, device)
    syms = decode_lanes_aligned(to_device(refills, dev), st, fq)
    return syms.cpu().numpy().reshape(-1)[:n_symbols]


"""The lane path's three kernels at their chip_smoke.py shapes: lane_compose
(csrc/bc_compose.cu's lane instance) at a random B=4 1080p step, and the
two rANS decodes (csrc/rans_lanes.cu) of a dense 1080p window at N=4096
lanes and B=4; their inputs, the bytes each call must move, and their times
as CUDA events around wrapper calls and as a CUDA graph.

    python -m jsplayer_tpu_torch.experiments.lane_step

prints one JSON line: {"card": "<name>, <power limit>", "lane_compose":
{"ms", "graph_ms", "bytes", "bound_ms", "exact"}, "rans_chain_probe":
{"ms", "graph_ms", "exact"}, "rans_decode_aligned": {..., "bytes_share",
"chain_bound_ms", "chain_share", "share", "msym_s", "graph_msym_s",
"instance"}, "rans_decode_packed": {...}, "sm_clocks": "<clocks.sm,
clocks.max.sm>"}; `exact` holds each result against its plain twin, bit
for bit.  The chain bound is the chain probe's graph time (chain_probe):
the least time the card takes for the decodes' lockstep chains, which for
these lanes is larger than the bytes bound; `share` is the larger bound
over the graph time.  In a checkout whose kernels have no probe the chain
fields are null.  `sm_clocks` is read while the aligned decode runs.

The random step (step_inputs) is bc_step's with rows for a plane: codes
0..5 and 255, rects with bounds 0..20 and a third of whole blocks,
wrapping vectors, stream 2 unchanged; rows_unique [4, 512, 1920] random
u32 words (the top byte set in most), the [:, :, :1920] view of
[4, 512, 2048] rows as the ingest lays them out; row_idx over
[-576, 576): in range, wrapping negatives and indices past either end.
The dense window (dense_units) is the unit bytes of seven frames of
utils/corpora.video_call's 640x360 playing video: 12,600 128-pixel units,
4,838,400 byte-plane symbols, 1,182 lockstep steps of 4096 lanes once
encoded by the port's build_freq_table, encode_lanes and layout_refills
(a few seconds of pure-Python encoding, made once a run).  The script
calls only the public signatures of the wrappers, so copied with
experiments/common.py and block_step.py into another checkout of the port,
it times that checkout's kernels on the same inputs in the same way.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from .. import _build
from .bc_step import step_inputs as bc_inputs
from .block_step import B, X, Y
from .common import HBM_BYTES_PER_MS, bc_data_pixels, card, graph_ms, \
    io_bytes, sm_clocks, time_ms

UR = 512           # rows of the random step's row table
N_LANES = 4096     # lanes a stream (transcode_to_lane's choice at 1080p)


def step_inputs(device, seed: int = 0):
    """The random B=4 1080p lane step → (prev, [rows, row_idx, bcode, rloc,
    mvk], changed) on `device`."""
    prev, (_, bcode, rloc, mvk), chg = bc_inputs(device, seed)
    rng = np.random.default_rng(seed + 100)
    wide = rng.integers(0, 1 << 32, (B, UR, 2048), dtype=np.uint32)
    rows = torch.from_numpy(wide.view(np.int32)).to(device)[:, :, :X]
    row_idx = rng.integers(-UR - 64, UR + 64, (B, Y)).astype(np.int32)
    return (prev, [rows, torch.from_numpy(row_idx).to(device), bcode, rloc,
                   mvk], chg)


def lane_bytes(prev, args, chg, dram: bool = False) -> int:
    """Bytes one lane_compose step (args: rows, row_idx, bcode, rloc, mvk)
    must move on its data: out written; an unchanged stream reads prev; a
    changed one reads prev at every pixel outside its code-1 rects, and
    once each distinct rows word its data pixels gather (an index outside
    the rows reads nothing: jnp.take's fill); its commands and row_idx, and
    changed.  dram: leave out every read of prev, as in a scan, where prev
    is the step before's out, warm in the 50 MB L2."""
    rows, row_idx, bcode, rloc, mvk = args
    Bn, Yn, Xn = prev.shape
    Ur = rows.shape[1]
    words = prev.numel() * (1 if dram else 2)
    cmds = 0
    for b in range(Bn):
        if not bool(chg[b]):
            continue
        cmds += io_bytes(bcode[b], rloc[b], mvk[b], row_idx[b])
        data = bc_data_pixels(bcode[b], rloc[b], Yn, Xn)
        if not dram:
            words -= int(data.sum())  # data pixels do not read prev
        ri = row_idx[b].to(torch.int64)
        ri = torch.where(ri < 0, ri + Ur, ri)
        ok = (ri >= 0) & (ri < Ur)
        use = data & ok[:, None]
        key = (ri[:, None] * Xn + torch.arange(Xn, device=ri.device))[use]
        words += int(torch.unique(key).numel())
    return 4 * words + cmds + io_bytes(chg)


def dense_units(T: int = 8) -> np.ndarray:
    """Unit byte planes of a dense window: the 640x360 video of
    utils/corpora.video_call frames 1..T-1, the padded plane's 128-pixel
    units that cover it (five a row) → symbols u8 [U * 384] in the lane
    container's order (unit by unit, byte plane by byte plane)."""
    from ..utils.corpora import video_call

    frames = video_call(T=T, Y=Y, X=X)
    vy, vx = (Y - 360) // 2, (X - 640) // 2
    units = np.concatenate([f[vy:vy + 360, vx:vx + 640].reshape(-1, 128)
                            for f in frames[1:]])
    planes = np.stack([(units >> s) & 0xFF for s in (0, 8, 16)], axis=1)
    return planes.astype(np.uint8).reshape(-1)


def dense_rans(n_lanes: int = N_LANES) -> dict:
    """dense_units encoded as one stream's lane container bulk would be →
    {"syms", "freq", "lane_bytes", "states", "n", "steps", "refills"}."""
    from ..kernels import rans_lanes as R

    syms = dense_units()
    freq = R.build_freq_table(syms)
    lane_bytes, states, n = R.encode_lanes(syms, freq, n_lanes)
    steps = -(-n // n_lanes)
    return dict(syms=syms, freq=freq, lane_bytes=lane_bytes, states=states,
                n=n, steps=steps,
                refills=R.layout_refills(lane_bytes, states, freq, steps))


def rans_batch(d: dict, device, Bn: int = B) -> dict:
    """One stream's encoded window repeated over Bn streams, on `device` →
    the rANS wrappers' arguments {"refills", "lane_bytes", "states",
    "freq", "steps"}."""
    def rep(a, dtype=None):
        a = np.ascontiguousarray(np.broadcast_to(a, (Bn,) + a.shape))
        return torch.from_numpy(a.view(dtype) if dtype else a).to(device)

    return dict(refills=rep(d["refills"]), lane_bytes=rep(d["lane_bytes"]),
                states=rep(d["states"], np.int32), freq=rep(d["freq"]),
                steps=d["steps"])


def random_rans(device, Bn: int = B, steps: int = 1182, L: int = 900,
                seed: int = 0) -> dict:
    """Random u32 states (0 and 2^31 among them), refills and lane bytes
    at N_LANES lanes, a positive table summing to 4096 a stream → the
    rANS wrappers' arguments, as rans_batch."""
    from ..kernels import rans_lanes as R

    rng = np.random.default_rng(seed)
    st = rng.integers(0, 1 << 32, (Bn, N_LANES), dtype=np.uint64) \
        .astype(np.uint32)
    st[:, :2] = (0, 2**31)
    freq = np.stack([R.build_freq_table(
        rng.integers(0, 256, 5000).astype(np.uint8)) for _ in range(Bn)])
    t = [rng.integers(0, 256, s, dtype=np.uint8) for s in (
        (Bn, steps, N_LANES, 2), (Bn, N_LANES, L))]
    return dict(refills=torch.from_numpy(t[0]).to(device),
                lane_bytes=torch.from_numpy(t[1]).to(device),
                states=torch.from_numpy(st.view(np.int32)).to(device),
                freq=torch.from_numpy(freq).to(device), steps=steps)


def rans_bytes(a: dict, packed: bool) -> int:
    """Bytes a decode must move: the symbols written, the states and
    tables read, and the refill bytes (aligned: two a lane-step) or the
    lane bytes the lanes consume (packed: min(cursor, L) a lane, from the
    plain twin's cursors)."""
    from ..kernels.rans_lanes import rans_decode_packed_ref

    Bn, N = a["states"].shape
    out = Bn * a["steps"] * N + io_bytes(a["states"], a["freq"])
    if not packed:
        return out + io_bytes(a["refills"])
    _, cursors = rans_decode_packed_ref(a["lane_bytes"], a["states"],
                                        a["freq"], a["steps"], cursors=True)
    L = a["lane_bytes"].shape[-1]
    return out + int(cursors.clamp(max=L).sum())


def rans_call(a: dict, packed: bool):
    """→ (the kernel's call, the plain twin's call) on the arguments a."""
    from ..kernels import rans_lanes as R

    if packed:
        args = (a["lane_bytes"], a["states"], a["freq"], a["steps"])
        return (lambda: R.rans_decode_packed(*args),
                lambda: R.rans_decode_packed_ref(*args))
    args = (a["refills"], a["states"], a["freq"])
    return (lambda: R.rans_decode_aligned(*args),
            lambda: R.rans_decode_aligned_ref(*args))


def msym_s(a: dict, ms: float) -> float:
    """Decoded symbols a second, in millions, of a call of `ms`."""
    Bn, N = a["states"].shape
    return Bn * a["steps"] * N / ms / 1e3


def chain_probe(states: torch.Tensor, freq: torch.Tensor,
                steps: int) -> torch.Tensor:
    """csrc/rans_lanes.cu's chain probe on the card: the decodes' grid and
    table build, then `steps` times one slot-table load, the multiply-add
    and one compare and select a lane, no global traffic in the loop →
    each lane's final state, int32 [B, N].  Its time is the chain bound: the
    least time the card takes for a lockstep table-driven decode of these
    lanes and steps."""
    out = torch.empty_like(states)
    rc = _build.load().jsp_rans_chain_probe(
        states.data_ptr(), states.stride(0), freq.data_ptr(), freq.stride(0),
        out.data_ptr(), out.stride(0), states.shape[0], states.shape[1],
        steps, torch.cuda.current_stream(states.device).cuda_stream)
    _build.check(rc, "rans_chain_probe")
    return out


def chain_probe_ref(states: torch.Tensor, freq: torch.Tensor,
                    steps: int) -> torch.Tensor:
    """Plain twin of chain_probe: the decode's symbol step, then x < 2^23
    takes x << 8 | 0x5A."""
    from ..kernels.rans_lanes import RANS_L, _decode_symbol, _tables

    f, cum = _tables(freq)
    x = states.to(torch.int64) & 0xFFFFFFFF
    for _ in range(steps):
        _, x = _decode_symbol(x, f, cum)
        x = torch.where(x < RANS_L, ((x << 8) | 0x5A) & 0xFFFFFFFF, x)
    return x.to(torch.int32)


def chain_bound(a: dict) -> dict:
    """The chain probe on the decodes' inputs a, checked against its twin →
    {"ms", "graph_ms", "build_graph_ms", "exact"}: graph_ms is the chain
    bound; build_graph_ms the probe with no steps, a launch that builds
    the tables and writes the states."""
    args = (a["states"], a["freq"], a["steps"])
    exact = torch.equal(chain_probe(*args), chain_probe_ref(*args))
    return dict(ms=time_ms(lambda: chain_probe(*args)),
                graph_ms=graph_ms(lambda: chain_probe(*args)),
                build_graph_ms=graph_ms(lambda: chain_probe(*args[:2], 0)),
                exact=exact)


def aligned_instance() -> str:
    """The aligned decode's instance of its last launch ("staged" or
    "bytes"), or "single" where the checkout's kernel has one instance."""
    from ..kernels.rans_lanes import rans_decode_aligned

    return getattr(rans_decode_aligned, "last_instance", None) or "single"


def rans_report(a: dict, packed: bool, chain: dict | None) -> dict:
    """One decode on the arguments a: events and graph times, Msym/s, the
    bytes bound, the chain bound (chain: chain_bound(a), or None where the
    checkout has no probe), each bound's share of the graph time and the
    larger one's, the instance that ran, and the result against the twin,
    bit for bit."""
    kernel, twin = rans_call(a, packed)
    exact = torch.equal(kernel(), twin())
    instance = "ring" if packed else aligned_instance()
    nbytes = rans_bytes(a, packed)
    ms, graph = time_ms(kernel), graph_ms(kernel)
    bound = nbytes / HBM_BYTES_PER_MS
    chain_ms = chain["graph_ms"] if chain else None
    return dict(ms=ms, graph_ms=graph, bytes=nbytes, bound_ms=bound,
                bytes_share=bound / graph, chain_bound_ms=chain_ms,
                chain_share=chain_ms / graph if chain else None,
                share=max(bound, chain_ms or 0.0) / graph,
                msym_s=msym_s(a, ms), graph_msym_s=msym_s(a, graph),
                instance=instance, exact=exact)


def main() -> None:
    from ..kernels.lane_recon import lane_compose, lane_compose_ref

    device, line = card()
    prev, args, chg = step_inputs(device)
    out = torch.empty_like(prev)

    def call():
        lane_compose(prev, *args, chg, out=out)

    call()
    nbytes = lane_bytes(prev, args, chg)
    res = {"lane_compose": dict(
        ms=time_ms(call), graph_ms=graph_ms(call), bytes=nbytes,
        bound_ms=nbytes / HBM_BYTES_PER_MS,
        exact=torch.equal(out, lane_compose_ref(prev, *args, chg)))}
    a = rans_batch(dense_rans(), device)
    # None in a checkout from before the probe
    chain = chain_bound(a) if hasattr(_build.load(),
                                      "jsp_rans_chain_probe") else None
    res["rans_chain_probe"] = chain
    for name, packed in (("rans_decode_aligned", False),
                         ("rans_decode_packed", True)):
        res[name] = rans_report(a, packed, chain)
    kernel, _ = rans_call(a, False)
    res["sm_clocks"] = sm_clocks(kernel)  # under the aligned decode
    print(json.dumps(dict(card=line, **res)), flush=True)


if __name__ == "__main__":
    main()

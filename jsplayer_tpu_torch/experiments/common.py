"""Helpers the experiment entry points share: inputs, timing, reporting,
and the bytes a kernel call must move."""

from __future__ import annotations

import subprocess

import torch

from ..device import resolve_device

#: the H100 SXM's device-memory rate, bytes a millisecond (3.35 TB/s,
#: NVIDIA's data sheet)
HBM_BYTES_PER_MS = 3.35e9


def card_line() -> str:
    """Card 0's `name, power.limit` as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def card() -> tuple[torch.device, str]:
    """(the first CUDA device, its card_line()).  Raises where there is no
    card: the experiments measure the card."""
    return resolve_device("cuda:0"), card_line()


def rand_frames(shape, device, seed: int = 0) -> torch.Tensor:
    """Uniform random u32 words (int32 bits) made on `device` from `seed`:
    all 32 bits vary, so the probes' masks and wrapping sums are exercised."""
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(-2**31, 2**31, tuple(shape), dtype=torch.int32,
                         device=device, generator=g)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """ms per call on the card: CUDA events around `iters` calls after
    `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """ms per call of fn's device work, without the host's launch cost:
    `iters` calls (after warm-up calls on a side stream) captured into one
    CUDA graph, CUDA events around `replays` replays.  fn's allocations on
    the card are made once, at capture, from the graph's own pool; its
    host work (checks, launches) is not replayed."""
    graph = capture(fn, iters)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * replays)


#: bytes that flush the L2 between the calls cold_ms times: five times
#: the 50 MB L2
L2_FLUSH_BYTES = 256 << 20


def cold_ms(fn, iters: int = 20, read: bool = False) -> float:
    """ms per call of fn's device work with a cold L2: fn captured into a
    CUDA graph of one call; before each of `iters` replays a 256 MB buffer
    is written (which evicts the call's inputs and leaves the L2 holding
    the buffer's dirty lines) or, with `read`, summed (clean lines), and
    CUDA events time only the replay.  The flush keeps the card busy for
    longer than the replay takes to launch, so no launch gap enters the
    time."""
    graph = capture(fn, 1)
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32,
                        device=torch.cuda.current_device())
    flush.fill_(1)
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for i, (start, end) in enumerate(events):
        if read:
            flush.sum()
        else:
            flush.fill_(i)
        start.record()
        graph.replay()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def capture(fn, iters: int) -> torch.cuda.CUDAGraph:
    """`iters` calls of fn, after warm-up calls on a side stream, captured
    into one CUDA graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return graph


def sm_clocks(fn, calls: int = 20000) -> str:
    """Card 0's `clocks.sm, clocks.max.sm` as nvidia-smi reports them while
    the card runs `calls` calls of fn, replayed from one CUDA graph."""
    graph = capture(fn, 20)
    for _ in range(calls // 20):
        graph.replay()
    line = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    torch.cuda.synchronize()
    return line


def io_bytes(*ts: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def block_bytes(name: str, prev, args, chg, dram: bool = False) -> int:
    """Bytes one csrc/sp_motion.cu step (kernel `name`, its wrapper's
    arguments `args` between prev and changed) must move on its commands:
    out written, and one source word read a pixel (payload inside a data
    block's rect, prev elsewhere; an unchanged stream reads prev); the mxu
    mode reads its paycode word wherever a block is not motion, and prev
    besides where that word's top byte is 0.  Plus the command arrays and
    changed.  dram: leave out every read of prev, as in a scan, where prev
    is the step before's out, warm in the 50 MB L2."""
    from ..kernels.sp_recon import block_broadcast, block_grid, block_masks

    Bn, Yn, Xn = prev.shape
    nby, nbx = block_grid(Yn, Xn)
    words = prev.numel() * (1 if dram else 2)
    for b in range(Bn):
        if not bool(chg[b]):
            continue
        if name == "sp_motion_mxu":
            paycode, _, is_motion = args
            still = block_broadcast(is_motion[b], nby, nbx, Yn, Xn) == 0
            if not dram:  # prev besides paycode
                still &= ((paycode[b] >> 24) & 0xFF) == 0
            words += int(still.sum())
        elif dram:  # payload words only
            bts, _, rect = args[:3]
            _, _, k, in_rect = block_masks(bts[b], rect[b], Yn, Xn)
            data = (k > 0) & in_rect & (
                ((k - 1) & 2) == 0 if name == "sp_compose_general"
                else k != 3)
            words += int(data.sum())
    cmds = io_bytes(*args[1:]) if name == "sp_motion_mxu" else \
        io_bytes(*args[:3])
    return 4 * words + cmds + io_bytes(chg)


def bc_data_pixels(bcode, rloc, Y: int, X: int) -> torch.Tensor:
    """bool [Y, X]: the pixels inside a code-1 rect of one frame's bcode
    [NB] and rloc [NB, 4] (the only plane words csrc/bc_compose.cu
    reads)."""
    from ..kernels.sp_recon import bc_row_map, block_grid, row_expand

    rowv = row_expand(bc_row_map(bcode, rloc, *block_grid(Y, X), X), Y, X)
    ly = torch.arange(Y, device=rowv.device)[:, None] & 15
    return ((rowv & 0xFF) == 1) & (ly >= ((rowv >> 8) & 0xFF)) & (
        ly < ((rowv >> 16) & 0xFF))


def bc_bytes(prev, args, chg, dram: bool = False) -> int:
    """Bytes one csrc/bc_compose.cu step (args: plane, bcode, rloc, mvk)
    must move: out written and one source word read a pixel (the plane
    inside a code-1 rect, prev elsewhere, moved or in place; an unchanged
    stream reads prev), plus the command arrays of the changed streams and
    changed.  dram: leave out every read of prev, as in a scan, where prev
    is the step before's out, warm in the 50 MB L2."""
    plane, bcode, rloc, mvk = args
    Bn, Yn, Xn = prev.shape
    words = prev.numel() * (1 if dram else 2)
    cmds = 0
    for b in range(Bn):
        if not bool(chg[b]):
            continue
        cmds += io_bytes(bcode[b], rloc[b], mvk[b])
        if dram:
            words += int(bc_data_pixels(bcode[b], rloc[b], Yn, Xn).sum())
    return 4 * words + cmds + io_bytes(chg)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal dtype, shape and bits (bf16 through int16 views)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return torch.equal(a, b)


def measure(kernel, twin, frames: torch.Tensor, iters: int = 20) -> dict:
    """Run `kernel(frames)` and `twin(frames)`, compare them bit for bit →
    {"parity", "shape", "ms", "plain_ms"}.  Times are CUDA-event ms per
    call on the card, None for tensors on the CPU."""
    got = kernel(frames)
    want = twin(frames)
    res = {"parity": same_bits(got, want), "shape": list(got.shape),
           "ms": None, "plain_ms": None}
    del got, want
    if frames.is_cuda:
        res["ms"] = time_ms(lambda: kernel(frames), iters)
        res["plain_ms"] = time_ms(lambda: twin(frames), iters)
    return res


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def require_parity(results: dict, what: str) -> None:
    """Raise if any entry of results {name: {"parity": bool, ...}} failed."""
    bad = sorted(k for k, r in results.items() if not r["parity"])
    if bad:
        raise RuntimeError(f"{what}: not bit-exact: {bad}")

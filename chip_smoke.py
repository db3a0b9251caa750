"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from jsplayer_tpu_torch/csrc/, holds each
against its plain torch twin on the card at 1080p, then drives the port's
main path — batched 1080p ScreenPressor kmv ingest with still-elision and
the ds2 model epilogue — through jsplayer_tpu_torch.VideoIngestPipeline,
checks its frames against the source frames (the codec is lossless) and
its model tensors against the plain CPU epilogue, bit for bit.

Any failure raises (non-zero exit).  Without CUDA it exits 2 before doing
anything.  The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}};
the line before it is the card's `name, power.limit`, and before that a
JSON object with each kernel's launches, error and times.  Imports nothing
of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

B, T, Y, X = 4, 128, 1080, 1920  # the slice: 4 streams x 128 frames, 1080p
WINDOW = 64
KEYFRAMES = (0, 40)  # shared keyframes: windows [0,40) [40,104) CONCAT,
#                      [104,128) starts mid-GOP -> PADDED


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


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


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


# ---------------------------------------------------------------------------

def phase_env() -> str:
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    from jsplayer_tpu_torch import _build

    nvcc = _build.find_nvcc()
    require(nvcc is not None, "nvcc present")
    ver = subprocess.run([nvcc, "--version"], check=True,
                         capture_output=True, text=True).stdout
    log(f"nvcc: {ver.strip().splitlines()[-1]}")
    from jsplayer_tpu import native

    ok = native.available()
    log(f"jsplayer_tpu.native.available(): {ok}")
    require(ok, "native host decoder builds and loads")
    return card


def phase_build() -> None:
    from jsplayer_tpu_torch import _build

    t0 = time.perf_counter()
    _build.load()
    dt = time.perf_counter() - t0
    info = _build.last_build
    log(f"kernel build+load: {dt:.3f} s"
        + (f" (nvcc {info['seconds']:.3f} s)" if info else " (up to date)"))
    if info:
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  ptxas: {line.strip()}")


def phase_kernels(card: str) -> dict:
    from jsplayer_tpu_torch.kernels.rgb_convert import ds2_pack, ds2_pack_ref
    from jsplayer_tpu_torch.kernels.sp_recon import kmv_compose, kmv_compose_ref

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    res = {}

    # kmv_compose: B=4, K=2, every ptype and kslot, wrapping vectors
    Bk, K = 4, 2
    prev = torch.from_numpy(
        rng.integers(0, 1 << 32, (Bk, Y, X), dtype=np.uint64)
        .astype(np.uint32).view(np.int32)).to(dev)
    word = (rng.integers(0, 1 << 24, (Bk, Y, X), dtype=np.uint32)
            | (rng.integers(0, 4, (Bk, Y, X), dtype=np.uint32) << 24)
            | (rng.integers(0, 8, (Bk, Y, X), dtype=np.uint32) << 26))
    pc = torch.from_numpy(word.view(np.int32)).to(dev)
    mvk = torch.tensor([[[3, -5], [-7, 2]],            # small, negative
                        [[-2000, 1500], [1925, -1085]],  # out of frame
                        [[16, 16], [-16, 0]],           # chg = 0 stream
                        [[0, Y], [-X, -2 * Y - 1]]],    # |mv| >= Y, X
                       dtype=torch.int32, device=dev)
    chg = torch.tensor([True, True, False, True], device=dev)
    got = kmv_compose(prev, pc, mvk, chg)
    want = kmv_compose_ref(prev, pc, mvk, chg)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    require(torch.equal(got, want), "kmv_compose bit-exact vs plain")
    out = torch.empty_like(prev)
    ms = time_ms(lambda: kmv_compose(prev, pc, mvk, chg, out=out))
    plain_ms = time_ms(lambda: kmv_compose_ref(prev, pc, mvk, chg))
    log(f"kmv_compose [{Bk},{Y},{X}] K={K}: bit-exact; kernel {ms:.4f} "
        f"ms/call, plain {plain_ms:.4f} ms/call ({card})")
    res["kmv_compose"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    del prev, pc, got, want, out

    # ds2_pack: [64,1080,1920] with and without flip, and an odd shape
    errs, times = [], {}
    for shape in ((64, Y, X), (3, Y + 1, X + 3)):
        fr = torch.from_numpy(
            rng.integers(0, 1 << 32, shape, dtype=np.uint64)
            .astype(np.uint32).view(np.int32)).to(dev)
        for flip in (False, True):
            got = ds2_pack(fr, flip=flip)
            want = ds2_pack_ref(fr, flip=flip)
            torch.cuda.synchronize()
            errs.append(max_abs_err(got, want))
            require(torch.equal(got, want),
                    f"ds2_pack bit-exact vs plain {shape} flip={flip}")
            ms = time_ms(lambda: ds2_pack(fr, flip=flip))
            plain_ms = time_ms(lambda: ds2_pack_ref(fr, flip=flip))
            times[(shape, flip)] = (ms, plain_ms)
            log(f"ds2_pack {list(shape)} flip={flip}: bit-exact; kernel "
                f"{ms:.4f} ms/call, plain {plain_ms:.4f} ms/call ({card})")
        del fr, got, want
    ms, plain_ms = times[((64, Y, X), False)]
    res["ds2_pack"] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms)
    return res


def make_streams():
    """B SP v4 1080p streams of T frames, the bench screen mix (scroll +
    paint events, a third stills) with keyframes at KEYFRAMES → (AVI bytes
    per stream, source frames [B] of [T, Y, X] u32)."""
    from jsplayer_tpu import native
    from jsplayer_tpu.encode.avi_mux import mux_avi
    from jsplayer_tpu.utils.corpora import screen_mix

    # load the library before the threads: native.load() is not thread-safe
    require(native.available(), "native host encoder loads")

    def one(seed):
        frames = np.stack(screen_mix(T=T, Y=Y, X=X, seed=seed))
        enc = native.NativeScreenPressorEncoder(4, X, Y)
        chunks = [enc.encode_i(f.reshape(-1)) if t in KEYFRAMES
                  else enc.encode_p(f.reshape(-1))
                  for t, f in enumerate(frames)]
        keys = [t in KEYFRAMES for t in range(T)]
        return mux_avi(chunks, X, Y, 24, codec="SPV4", keyflags=keys), frames

    with ThreadPoolExecutor(B) as ex:
        got = list(ex.map(one, range(B)))
    return [g[0] for g in got], [g[1] for g in got]


def run_ingest(avis, **kw):
    """Drive the port's pipeline once → (window dicts, stats, seconds)."""
    from jsplayer_tpu_torch import IngestConfig, MemorySource, VideoIngestPipeline

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe = VideoIngestPipeline(
        [MemorySource(a) for a in avis],
        IngestConfig(window=WINDOW, still_elision=True, model_downscale=2,
                     device="cuda", **kw))
    batches = list(pipe)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    require(not pipe.quarantined, f"no stream quarantined "
            f"({pipe.quarantine_errors})")
    return batches, dict(pipe.stats), dt


def timeline_rows(batches, b):
    """Stream b's timeline → [(window index, row)] through outmap (-1 =
    the previous window's row for this stream)."""
    rows, last = [], None
    for w, batch in enumerate(batches):
        om = np.asarray(batch["outmap"])
        require(om.ndim == 2, "batched outmap [B, T]")
        # the last window is not trimmed: slots past the stream's end pad
        for t in range(min(om.shape[1], T - batch["start_frame"])):
            if om[b, t] >= 0:
                last = (w, int(om[b, t]))
            require(last is not None, f"stream {b} frame resolves to a row")
            rows.append(last)
    require(len(rows) == T, f"stream {b} timeline covers {T} frames")
    return rows


def gather(batches, rows, key):
    """Stack the rows [(window, row)] of batches[*][key] on the card."""
    out = []
    for w, batch in enumerate(batches):
        idx = [r for (ww, r) in rows if ww == w]
        if idx:
            out.append(batch[key][torch.tensor(idx, device=batch[key].device)])
    return torch.cat(out)


def phase_slice(card: str) -> dict:
    from jsplayer_tpu_torch.kernels.rgb_convert import ds2_pack, to_model_input
    from jsplayer_tpu_torch.kernels.sp_recon import kmv_compose

    t0 = time.perf_counter()
    avis, src = make_streams()
    log(f"made {B} streams x {T} frames {X}x{Y} "
        f"({sum(len(a) for a in avis)} AVI bytes) in "
        f"{time.perf_counter() - t0:.3f} s")

    kmv_compose.launches = 0
    ds2_pack.launches = 0
    runs = {}
    runs["a"] = run_ingest(avis)
    runs["b"] = run_ingest(avis, emit_frames=False)
    launches = {"kmv_compose": kmv_compose.launches,
                "ds2_pack": ds2_pack.launches}
    log(f"main-path kernel launches: {launches}")
    for name, (batches, stats, dt) in runs.items():
        log(f"run ({name}): {stats}; {B * T} timeline frames in {dt:.3f} s "
            f"= {B * T / dt:.1f} delivered frames/s ({card})")
    concat = sum(r[1]["concat_windows"] for r in runs.values())
    padded = sum(r[1]["padded_windows"] for r in runs.values())
    require(concat > 0 and padded > 0,
            f"both elision layouts ran (concat {concat}, padded {padded})")
    require(all(n > 0 for n in launches.values()),
            f"every kernel of the path launched ({launches})")

    dev = torch.device("cuda", 0)
    ba, bb = runs["a"][0], runs["b"][0]
    require(all("frames_u32" not in x for x in bb),
            "run (b) emits no frame stack")
    for b in range(B):
        # (a): every timeline frame equals the source frame, bit for bit
        ra, rb = timeline_rows(ba, b), timeline_rows(bb, b)
        s = torch.from_numpy(src[b].view(np.int32))
        require(torch.equal(gather(ba, ra, "frames_u32"), s.to(dev)),
                f"run (a) stream {b} frames == source frames")
        # (a) and (b): model tensors == the plain CPU epilogue
        want = torch.cat([to_model_input(s[i:i + 16], downscale=2)
                          for i in range(0, T, 16)]).view(torch.int16)
        want = want.to(dev)
        for name, batches, rows in (("a", ba, ra), ("b", bb, rb)):
            got = gather(batches, rows, "model_input")
            require(got.dtype == torch.bfloat16
                    and tuple(got.shape) == (T, Y // 2, X // 2, 3),
                    f"run ({name}) model_input bf16 [{T},{Y//2},{X//2},3]")
            require(torch.equal(got.view(torch.int16), want),
                    f"run ({name}) stream {b} model_input == plain CPU "
                    f"to_model_input(source, downscale=2)")
        log(f"stream {b}: frames and model tensors bit-exact")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this "
              "smoke run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    t_all = time.perf_counter()
    card = phase_env()
    phase_build()
    kernels = phase_kernels(card)
    launches = phase_slice(card)
    src = {"kmv_compose": ("jsplayer_tpu_torch/csrc/kmv_compose.cu",
                           "jsplayer_tpu/kernels/sp_recon.py:173"),
           "ds2_pack": ("jsplayer_tpu_torch/csrc/ds2_pack.cu",
                        "jsplayer_tpu/kernels/rgb_convert.py:165")}
    log(f"total {time.perf_counter() - t_all:.3f} s")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src[name][0],
         "replaces": src[name][1], "launches": launches[name],
         **kernels[name]} for name in ("kmv_compose", "ds2_pack")]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

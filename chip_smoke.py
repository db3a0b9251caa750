"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from jsplayer_tpu_torch/csrc/ and holds
each against its plain torch twin on the card at 1080p, B=4: kmv_compose
and ds2_pack on random inputs; the three modes of sp_motion.cu
(sp_compose_general, sp_motion_patch, sp_motion_mxu) on commands the
native decoder captured from the streams below, the general mode also on
random out-of-frame vectors.  Then it drives the port's paths on 4 SP v4
1080p streams of 128 frames through jsplayer_tpu_torch.VideoIngestPipeline:

  (a) kmv, still-elided, frames + ds2 model tensors (the main path);
  (b) the same, model tensors only;
  (c) sp_device_path="pallas" (sp_motion_patch), frames + model tensors;
  (d) sp_device_path="general" (sp_compose_general), the same;

and the MXU compose (sp_motion_mxu), which no ingest path runs, as a scan
over one whole decoded stream.  Every frame must equal its source frame
(the codec is lossless) and every model tensor the plain CPU epilogue, bit
for bit.  Then phase (e), the ds2 experiments (jsplayer_tpu_torch.
experiments): kmv_compose_ds2 (csrc/kmv_compose.cu's fused compose+ds2
instance) on random inputs and every mode of csrc/ds_probe.cu at its
script's full shape, each against its plain twin; then the experiments'
entry points: exp_model_fusion2's seven variants on the 1080p bench-mix
stream, all equal to variant A, and the three probe experiments.  Each
path runs with every launch count set to 0 just before it and read just
after; each kernel must have launched on its path.

Any failure raises (non-zero exit).  Without CUDA it exits 2 before doing
anything; without the repository around it the first import fails.  The
last line of standard output is
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

from jsplayer_tpu_torch.experiments.common import (card_line, rand_frames,
                                                   time_ms)

B, T, Y, X = 4, 128, 1080, 1920  # the slice: 4 streams x 128 frames, 1080p
WINDOW = 64
DEV = torch.device("cuda", 0)  # the one card the script needs
KEYFRAMES = (0, 40)  # shared keyframes: windows [0,40) [40,104) CONCAT,
#                      [104,128) starts mid-GOP -> PADDED


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


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

    rng = np.random.default_rng(0)
    res = {}

    # kmv_compose: B=4, K=2, every ptype and kslot, wrapping vectors
    Bk, K = 4, 2
    prev = torch.from_numpy(
        rng.integers(0, 1 << 32, (Bk, Y, X), dtype=np.uint64)
        .astype(np.uint32).view(np.int32)).to(DEV)
    word = (rng.integers(0, 1 << 24, (Bk, Y, X), dtype=np.uint32)
            | (rng.integers(0, 4, (Bk, Y, X), dtype=np.uint32) << 24)
            | (rng.integers(0, 8, (Bk, Y, X), dtype=np.uint32) << 26))
    pc = torch.from_numpy(word.view(np.int32)).to(DEV)
    mvk = torch.tensor([[[3, -5], [-7, 2]],            # small, negative
                        [[-2000, 1500], [1925, -1085]],  # out of frame
                        [[16, 16], [-16, 0]],           # chg = 0 stream
                        [[0, Y], [-X, -2 * Y - 1]]],    # |mv| >= Y, X
                       dtype=torch.int32, device=DEV)
    chg = torch.tensor([True, True, False, True], device=DEV)
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
            .astype(np.uint32).view(np.int32)).to(DEV)
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
    per stream, source frames [B] of [T, Y, X] u32, frame bytes [B] of
    [T])."""
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
        return (mux_avi(chunks, X, Y, 24, codec="SPV4", keyflags=keys),
                frames, chunks)

    with ThreadPoolExecutor(B) as ex:
        got = list(ex.map(one, range(B)))
    return tuple([g[i] for g in got] for i in range(3))


def run_ingest(avis, still_elision=True, **kw):
    """Drive the port's pipeline once → (window dicts, stats, seconds)."""
    from jsplayer_tpu_torch import IngestConfig, MemorySource, VideoIngestPipeline

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe = VideoIngestPipeline(
        [MemorySource(a) for a in avis],
        IngestConfig(window=WINDOW, still_elision=still_elision,
                     model_downscale=2, device=str(DEV), **kw))
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


def kernel_counters() -> dict:
    """name → the wrapper whose `.launches` counts that kernel's launches."""
    from jsplayer_tpu_torch.kernels.ds_probe import ds_probe
    from jsplayer_tpu_torch.kernels.rgb_convert import ds2_pack
    from jsplayer_tpu_torch.kernels.sp_motion_mxu import sp_motion_mxu
    from jsplayer_tpu_torch.kernels.sp_motion_pallas import sp_motion_patch
    from jsplayer_tpu_torch.kernels.sp_recon import (kmv_compose,
                                                     kmv_compose_ds2,
                                                     sp_compose_general)

    return {"kmv_compose": kmv_compose, "ds2_pack": ds2_pack,
            "sp_compose_general": sp_compose_general,
            "sp_motion_patch": sp_motion_patch,
            "sp_motion_mxu": sp_motion_mxu,
            "kmv_compose_ds2": kmv_compose_ds2, "ds_probe": ds_probe}


def count_launches(fn):
    """Run fn() with every kernel's launch count set to 0 just before it →
    (fn's result, {kernel: launches during fn}); ds_probe's launches per
    mode under "ds_probe_modes"."""
    from jsplayer_tpu_torch.kernels.ds_probe import ds_probe

    counters = kernel_counters()
    for w in counters.values():
        w.launches = 0
    ds_probe.by_mode.clear()
    res = fn()
    got = {name: w.launches for name, w in counters.items()}
    got["ds_probe_modes"] = dict(ds_probe.by_mode)
    return res, got


def capture(chunks):
    """The native decoder's capture of the streams → torch tensors on the
    card: bts [B,T,NB], mv [B,T,NB,2], rect [B,T,NB,4], payload
    [B,T,Y,X] int32 bits, changed [B,T] bool."""
    from jsplayer_tpu import native

    t0 = time.perf_counter()
    got = native.native_sp_decode_streams(chunks, X, Y)
    log(f"native capture of {len(chunks)} x {len(chunks[0])} frames: "
        f"{time.perf_counter() - t0:.3f} s")
    out = {k: torch.from_numpy(np.ascontiguousarray(got[k]).view(np.int32))
           .to(DEV) for k in ("bts", "mv", "rect", "payload")}
    out["changed"] = torch.from_numpy(got["changed"].astype(bool)).to(DEV)
    return out


def phase_block_kernels(card: str, cap: dict, src) -> dict:
    """The three modes of sp_motion.cu at 1080p, B=4, against their plain
    twins, bit for bit, on one decoder-captured scan step of every stream
    (and the general mode on random out-of-frame vectors); each result must
    also equal the source frames."""
    from jsplayer_tpu_torch.kernels import sp_motion_mxu as PM
    from jsplayer_tpu_torch.kernels import sp_motion_pallas as PP
    from jsplayer_tpu_torch.kernels import sp_recon as P

    # the step with the most full-block motion over all streams, every
    # stream changed
    n3 = (cap["bts"] == 3).sum(dim=(0, 2))
    ok = cap["changed"].all(dim=0)
    ok[0] = False
    t = int(torch.where(ok, n3, -1).argmax())
    require(bool(ok[t]) and int(n3[t]) > 0,
            "a scan step with motion blocks in every stream")
    prev = torch.stack([s[t - 1] for s in src]).to(DEV)
    want_frames = torch.stack([s[t] for s in src]).to(DEV)
    cmds = [cap[k][:, t].contiguous() for k in ("bts", "mv", "rect",
                                               "payload")]
    chg = torch.ones(B, dtype=torch.bool, device=DEV)
    mxu = [torch.stack(c) for c in zip(*(
        PM.mxu_commands(*(c[b] for c in cmds)) for b in range(B)))]
    rng = np.random.default_rng(1)
    rnd = [torch.from_numpy(a).to(DEV) for a in (
        rng.integers(-1, 8, cmds[0].shape).astype(np.int32),
        rng.integers(-3000, 3000, cmds[1].shape).astype(np.int32),
        cmds[2].cpu().numpy(),
        rng.integers(0, 1 << 32, cmds[3].shape, dtype=np.uint64)
        .astype(np.uint32).view(np.int32))]
    log(f"block kernels at step {t}: {int(n3[t])} bts-3 blocks over {B} "
        f"streams")
    res = {}
    for name, step, ref, args, exact in (
            ("sp_compose_general", P.sp_compose_general, P.compose_frame_ref,
             cmds, True),
            ("sp_compose_general", P.sp_compose_general, P.compose_frame_ref,
             rnd, False),
            ("sp_motion_patch", PP.sp_motion_patch, PP.compose_frame_fast_ref,
             cmds, True),
            ("sp_motion_mxu", PM.sp_motion_mxu, PM.compose_frame_mxu_ref,
             mxu, True)):
        got = step(prev, *args, chg)
        want = P.per_stream_ref(ref, prev, chg, *args)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        require(torch.equal(got, want), f"{name} bit-exact vs plain")
        if exact:
            require(torch.equal(got, want_frames),
                    f"{name} composes the source frames")
        what = "captured" if exact else "random out-of-frame"
        if name in res:  # the extra case adds its error, not its times
            res[name]["max_abs_err"] = max(res[name]["max_abs_err"], err)
            log(f"{name} [{B},{Y},{X}] {what}: bit-exact")
            continue
        out = torch.empty_like(prev)
        ms = time_ms(lambda: step(prev, *args, chg, out=out))
        plain_ms = time_ms(lambda: P.per_stream_ref(ref, prev, chg, *args))
        log(f"{name} [{B},{Y},{X}] {what}: bit-exact; kernel {ms:.4f} "
            f"ms/call, plain {plain_ms:.4f} ms/call ({card})")
        res[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    return res


def phase_mxu_scan(card: str, cap: dict, src) -> dict:
    """The MXU compose's path (no ingest route runs it): a scan over
    stream 0's whole capture, one sp_motion_mxu launch a changed frame,
    every frame checked against the source frame."""
    from jsplayer_tpu_torch.kernels.sp_motion_mxu import (mxu_commands,
                                                          sp_motion_mxu)

    chg = torch.ones(1, dtype=torch.bool, device=DEV)

    def scan():
        prev = torch.zeros((1, Y, X), dtype=torch.int32, device=DEV)
        frames = torch.empty((T, Y, X), dtype=torch.int32, device=DEV)
        for t in range(T):
            if bool(cap["changed"][0, t]):
                args = mxu_commands(*(cap[k][0, t] for k in (
                    "bts", "mv", "rect", "payload")))
                sp_motion_mxu(prev, *(a[None] for a in args), chg,
                              out=frames[t:t + 1])
            else:
                frames[t] = prev[0]
            prev = frames[t:t + 1]
        torch.cuda.synchronize()
        return frames

    t0 = time.perf_counter()
    frames, launches = count_launches(scan)
    dt = time.perf_counter() - t0
    require(torch.equal(frames, src[0].to(DEV)),
            "mxu scan: every frame == source frame")
    log(f"mxu scan: stream 0, {T} frames bit-exact in {dt:.3f} s "
        f"({launches['sp_motion_mxu']} launches; {card})")
    return launches


def model_reference(src):
    """The plain CPU epilogue of every stream's source frames → int16 bits
    of to_model_input(downscale=2) on the card, [B] of [T, Y/2, X/2, 3]."""
    from jsplayer_tpu_torch.kernels.rgb_convert import to_model_input

    return [torch.cat([to_model_input(s[i:i + 16], downscale=2)
                       for i in range(0, T, 16)]).view(torch.int16).to(DEV)
            for s in src]


def check_model(got, want, what):
    require(got.dtype == torch.bfloat16
            and tuple(got.shape) == tuple(want.shape),
            f"{what} model_input bf16 {list(want.shape)}")
    require(torch.equal(got.view(torch.int16), want),
            f"{what} model_input == plain CPU to_model_input(source, "
            f"downscale=2)")


def phase_kmv_runs(card: str, avis, src, models) -> dict:
    """Runs (a) and (b): the main path, kmv with still-elision."""
    runs, launches = count_launches(lambda: {
        "a": run_ingest(avis), "b": run_ingest(avis, emit_frames=False)})
    log(f"kmv path (a)+(b) kernel launches: {launches}")
    for name, (batches, stats, dt) in runs.items():
        log(f"run ({name}) kmv: {stats}; {B * T} timeline frames in "
            f"{dt:.3f} s = {B * T / dt:.1f} delivered frames/s ({card})")
    concat = sum(r[1]["concat_windows"] for r in runs.values())
    padded = sum(r[1]["padded_windows"] for r in runs.values())
    require(concat > 0 and padded > 0,
            f"both elision layouts ran (concat {concat}, padded {padded})")
    require(launches["kmv_compose"] > 0 and launches["ds2_pack"] > 0,
            f"every kernel of the kmv path launched ({launches})")

    ba, bb = runs["a"][0], runs["b"][0]
    require(all("frames_u32" not in x for x in bb),
            "run (b) emits no frame stack")
    for b in range(B):
        # (a): every timeline frame equals the source frame, bit for bit
        ra, rb = timeline_rows(ba, b), timeline_rows(bb, b)
        require(torch.equal(gather(ba, ra, "frames_u32"), src[b].to(DEV)),
                f"run (a) stream {b} frames == source frames")
        # (a) and (b): model tensors == the plain CPU epilogue
        for name, batches, rows in (("a", ba, ra), ("b", bb, rb)):
            check_model(gather(batches, rows, "model_input"), models[b],
                        f"run ({name}) stream {b}")
        log(f"runs (a)/(b) stream {b}: frames and model tensors bit-exact")
    return launches


def phase_block_run(card: str, name: str, path: str, kernel: str, avis,
                    src, models) -> dict:
    """Run (c) or (d): sp_device_path `path`, dense windows of frames and
    ds2 model tensors, checked against the source frames and the plain
    epilogue."""
    torch.cuda.reset_peak_memory_stats(DEV)
    (batches, _, dt), launches = count_launches(
        lambda: run_ingest(avis, still_elision=False, sp_device_path=path))
    peak = torch.cuda.max_memory_allocated(DEV) / 2**30
    log(f"run ({name}) {path}: {len(batches)} windows, {B * T} frames in "
        f"{dt:.3f} s = {B * T / dt:.1f} delivered frames/s, peak device "
        f"memory {peak:.2f} GiB with every window kept ({card}); launches "
        f"{launches}")
    require(launches[kernel] > 0 and launches["ds2_pack"] > 0,
            f"run ({name}) launched {kernel} and ds2_pack ({launches})")
    require(sum(v for k, v in launches.items()
                if k not in (kernel, "ds2_pack", "ds_probe_modes")) == 0,
            f"run ({name}) launched no other compose ({launches})")
    for w in batches:
        t0, n = w["start_frame"], w["frames_u32"].shape[1]
        require(n == min(WINDOW, T - t0), f"run ({name}) window @{t0} "
                f"holds {n} frames")
        for b in range(B):
            require(torch.equal(w["frames_u32"][b],
                                src[b][t0:t0 + n].to(DEV)),
                    f"run ({name}) stream {b} window @{t0} frames == "
                    f"source frames")
            check_model(w["model_input"][b], models[b][t0:t0 + n],
                        f"run ({name}) stream {b} window @{t0}")
    require(sum(w["frames_u32"].shape[1] for w in batches) == T,
            f"run ({name}) covers {T} frames")
    log(f"run ({name}): every stream's frames and model tensors bit-exact")
    return launches


# ---------------------------------------------------------------------------
# Phase (e): the ds2 experiments

#: the ds_probe modes, each at its script's full stack depth
PROBE_DEPTH = {"ds2_fields": 64, "bitcast_fold": 64, "passthru": 64,
               "pack_h": 64, "sum4": 64, "hpair_i32": 4, "hpair_lowbyte": 4,
               "wpair_i32": 4, "block_transpose": 4}


def rand_dev(shape, seed):
    return rand_frames(shape, DEV, seed)


def phase_experiment_kernels(card: str) -> dict:
    """kmv_compose_ds2 on random B=4 inputs (wrapping vectors, an unchanged
    stream) and an odd shape; every ds_probe mode at its script's shape
    (BH=128, a partial last block); each bit-exact against its twin."""
    from jsplayer_tpu_torch.experiments.probes import probe_ref
    from jsplayer_tpu_torch.kernels.ds_probe import ds_probe
    from jsplayer_tpu_torch.kernels.rgb_convert import ds2_pack
    from jsplayer_tpu_torch.kernels.sp_recon import (kmv_compose,
                                                     kmv_compose_ds2,
                                                     kmv_compose_ds2_ref)

    res = {}
    errs, mvk_rows = [], [[[3, -5], [-7, 2]], [[-2000, 1500], [1925, -1085]],
                          [[16, 16], [-16, 0]], [[0, 1081], [-1923, -2163]]]
    for seed, (Bk, Yk, Xk) in enumerate(((4, Y, X), (3, Y + 1, X + 3))):
        prev = rand_dev((Bk, Yk, Xk), 10 + seed)
        kind = (rand_dev((Bk, Yk, Xk), 20 + seed) & (0x1F << 24)) \
            & ~(1 << 28)  # ptype 0..3, kslot 0..3
        pc = (rand_dev((Bk, Yk, Xk), 30 + seed) & 0x00FFFFFF) | kind
        mvk = torch.tensor(mvk_rows[:Bk], dtype=torch.int32, device=DEV)
        chg = torch.tensor([True, True, False, True][:Bk], device=DEV)
        got = kmv_compose_ds2(prev, pc, mvk, chg)
        want = kmv_compose_ds2_ref(prev, pc, mvk, chg)
        torch.cuda.synchronize()
        errs += [max_abs_err(g, w) for g, w in zip(got, want)]
        require(all(torch.equal(g, w) for g, w in zip(got, want)),
                f"kmv_compose_ds2 [{Bk},{Yk},{Xk}] bit-exact vs plain")
        if seed:
            log(f"kmv_compose_ds2 [{Bk},{Yk},{Xk}]: bit-exact")
            continue
        out = torch.empty_like(prev)
        red = torch.empty_like(got[1])
        ms = time_ms(lambda: kmv_compose_ds2(prev, pc, mvk, chg, out=out,
                                             red=red))
        plain_ms = time_ms(lambda: kmv_compose_ds2_ref(prev, pc, mvk, chg))
        unfused_ms = time_ms(lambda: ds2_pack(
            kmv_compose(prev, pc, mvk, chg, out=out), flip=False))
        log(f"kmv_compose_ds2 [{Bk},{Yk},{Xk}] K=2: bit-exact; kernel "
            f"{ms:.4f} ms/call, plain {plain_ms:.4f} ms/call, kmv_compose + "
            f"ds2_pack {unfused_ms:.4f} ms/call ({card})")
        res["kmv_compose_ds2"] = dict(ms=ms, plain_ms=plain_ms,
                                      unfused_ms=unfused_ms)
        del prev, pc, got, want, out, red
    res["kmv_compose_ds2"]["max_abs_err"] = max(errs)

    modes, frames = {}, {}
    for mode, depth in PROBE_DEPTH.items():
        if depth not in frames:
            frames[depth] = rand_dev((depth, Y, X), depth)
        f = frames[depth]
        got = ds_probe(f, mode)
        want = probe_ref(f, mode)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        require(torch.equal(got, want),
                f"ds_probe {mode} [{depth},{Y},{X}] bit-exact vs plain")
        ms = time_ms(lambda: ds_probe(f, mode))
        plain_ms = time_ms(lambda: probe_ref(f, mode))
        log(f"ds_probe {mode} [{depth},{Y},{X}] -> {list(got.shape)}: "
            f"bit-exact; kernel {ms:.4f} ms/call, plain {plain_ms:.4f} "
            f"ms/call ({card})")
        modes[mode] = dict(shape=list(got.shape), max_abs_err=err, ms=ms,
                           plain_ms=plain_ms)
        del got, want
    pack_ms = time_ms(lambda: ds2_pack(frames[64]))
    log(f"ds2_pack [64,{Y},{X}] beside ds2_fields: {pack_ms:.4f} ms/call "
        f"({card})")
    res["ds_probe"] = dict(max_abs_err=max(m["max_abs_err"]
                                           for m in modes.values()),
                           ms=modes["ds2_fields"]["ms"],
                           plain_ms=modes["ds2_fields"]["plain_ms"],
                           modes=modes)
    return res


def phase_experiments(card: str) -> dict:
    """The experiments' entry points: exp_model_fusion2's seven variants on
    the 1080p bench-mix stream (T=64, compacted), each equal to variant A;
    exp_pallas_ds's six variants, exp_pallas_ds2's and exp_pallas_bisect's
    probes at their scripts' shapes, each equal to its twin."""
    from jsplayer_tpu_torch.experiments import (exp_model_fusion2 as F,
                                                exp_pallas_bisect,
                                                exp_pallas_ds,
                                                exp_pallas_ds2)
    from jsplayer_tpu_torch.experiments.common import require_parity

    t0 = time.perf_counter()
    init, pc, mvk, nchanged = F.load_stream(DEV)
    log(f"bench-mix stream {F.X}x{F.Y}, {F.T} frames ({nchanged} changed), "
        f"encoded and decoded in {time.perf_counter() - t0:.3f} s")
    f64, f4 = rand_dev((64, Y, X), 64), rand_dev((4, Y, X), 4)

    def drive():
        return {"fusion2": F.run(init, pc, mvk),
                "exp_pallas_ds": exp_pallas_ds.run(f64, iters=5),
                "exp_pallas_ds2": exp_pallas_ds2.run(f64, iters=5),
                "exp_pallas_bisect": exp_pallas_bisect.run(f4, iters=5)}

    res, launches = count_launches(drive)
    log(f"phase (e) kernel launches: {launches}")
    for exp, r in res.items():
        require_parity(r, exp)
    eq = {v: r["equals_rw22"] for v, r in res["exp_pallas_ds"].items()}
    require(eq == {v: v != "bitcast" for v in eq},
            f"every exp_pallas_ds variant but bitcast equals rw22 ({eq})")
    for name, r in res["fusion2"].items():
        log(f"exp_model_fusion2 {name}: equal to A; {r['ms']:.4f} ms/call, "
            f"{r['fps']:.1f} delivered fps ({F.T} timeline frames; {card})")
    for exp in ("exp_pallas_ds", "exp_pallas_ds2", "exp_pallas_bisect"):
        for name, r in res[exp].items():
            log(f"{exp} {name} -> {r['shape']}: bit-exact; kernel "
                f"{r['ms']:.4f} ms/call, plain {r['plain_ms']:.4f} ms/call")
    for k in ("kmv_compose_ds2", "ds_probe", "kmv_compose", "ds2_pack"):
        require(launches[k] > 0, f"phase (e) launched {k} ({launches})")
    missing = set(PROBE_DEPTH) - set(launches["ds_probe_modes"])
    require(not missing, f"phase (e) launched every ds_probe mode "
            f"(missing {sorted(missing)})")
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

    t0 = time.perf_counter()
    avis, frames, chunks = make_streams()
    src = [torch.from_numpy(f.view(np.int32)) for f in frames]
    log(f"made {B} streams x {T} frames {X}x{Y} "
        f"({sum(len(a) for a in avis)} AVI bytes) in "
        f"{time.perf_counter() - t0:.3f} s")
    cap = capture(chunks)
    kernels.update(phase_block_kernels(card, cap, src))
    launches = {}
    mxu = phase_mxu_scan(card, cap, src)
    launches["sp_motion_mxu"] = mxu["sp_motion_mxu"]
    del cap
    models = model_reference(src)

    kmv = phase_kmv_runs(card, avis, src, models)
    launches.update(kmv_compose=kmv["kmv_compose"], ds2_pack=kmv["ds2_pack"])
    for name, path, kernel in (("c", "pallas", "sp_motion_patch"),
                               ("d", "general", "sp_compose_general")):
        got = phase_block_run(card, name, path, kernel, avis, src, models)
        launches[kernel] = got[kernel]
    del avis, frames, chunks, src, models

    kernels.update(phase_experiment_kernels(card))
    exp = phase_experiments(card)
    launches.update(kmv_compose_ds2=exp["kmv_compose_ds2"],
                    ds_probe=exp["ds_probe"])
    kernels["ds_probe"]["modes"] = {
        m: dict(v, launches=exp["ds_probe_modes"][m])
        for m, v in kernels["ds_probe"]["modes"].items()}

    routes = {
        "kmv_compose": ("jsplayer_tpu_torch/csrc/kmv_compose.cu",
                        "jsplayer_tpu/kernels/sp_recon.py:173"),
        "ds2_pack": ("jsplayer_tpu_torch/csrc/ds2_pack.cu",
                     "jsplayer_tpu/kernels/rgb_convert.py:165"),
        "sp_compose_general": ("jsplayer_tpu_torch/csrc/sp_motion.cu",
                               "jsplayer_tpu/kernels/sp_recon.py:53"),
        "sp_motion_patch": ("jsplayer_tpu_torch/csrc/sp_motion.cu",
                            "jsplayer_tpu/kernels/sp_motion_pallas.py:55"),
        "sp_motion_mxu": ("jsplayer_tpu_torch/csrc/sp_motion.cu",
                          "jsplayer_tpu/kernels/sp_motion_mxu.py:36"),
        "kmv_compose_ds2": ("jsplayer_tpu_torch/csrc/kmv_compose.cu",
                            "scripts/exp_model_fusion2.py:34"),
        "ds_probe": ("jsplayer_tpu_torch/csrc/ds_probe.cu",
                     "scripts/exp_pallas_ds.py:37; "
                     "scripts/exp_pallas_ds2.py:31,35,41; "
                     "scripts/exp_pallas_bisect.py:19-65")}
    log(f"total {time.perf_counter() - t_all:.3f} s")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": routes[name][0],
         "replaces": routes[name][1], "launches": launches[name],
         **kernels[name]} for name in routes]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

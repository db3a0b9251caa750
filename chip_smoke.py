"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's host library (jsplayer_tpu_torch/native/spdec.cpp, g++)
and its CUDA kernels (jsplayer_tpu_torch/csrc/, nvcc) into build/, and
holds each kernel against its plain torch twin on the card at 1080p, B=4:
kmv_compose and ds2_pack on random inputs; the three modes of sp_motion.cu
(sp_compose_general, sp_motion_patch, sp_motion_mxu) on commands the
native decoder captured from the streams below, the general mode also on
random out-of-frame vectors, and each mode again as a scan of stream 0's
B=1 steps.  Then it drives the port's paths on 4 SP v4 1080p streams of
128 frames through jsplayer_tpu_torch.VideoIngestPipeline:

  (a) kmv, still-elided, frames + ds2 model tensors (the main path);
  (b) the same, model tensors only;
  (c) sp_device_path="pallas" (sp_motion_patch), frames + model tensors;
  (d) sp_device_path="general" (sp_compose_general), the same;
  (f) sp_device_path="bc" (bc_compose), still-elided, frames + model
      tensors (CONCAT and PADDED windows);
  (g) bc, dense, model tensors only (decode_batch_bc_model);

and the MXU compose (sp_motion_mxu), which no ingest path runs, as a scan
over one whole decoded stream.  Every frame must equal its source frame
(the codec is lossless) and every model tensor the plain CPU epilogue, bit
for bit.  bc_compose is held against its twin on random B=4 1080p inputs
(wrapping vectors, codes past the motion slots, an unchanged stream, plane
words outside the data rects that differ between two calls, which must
agree), on the native bc transport's B=4 step with the most motion, and
over stream 0's B=1 steps.  The lane path: the streams transcoded by the
port's transcode_to_lane (window=64, K=2; raw and rans payloads, in
threads, the seconds logged apart); lane_compose (csrc/bc_compose.cu's
lane instance) against its twin on a random B=4 1080p step (wrapping
vectors, codes past 2+K, an unchanged stream, row indices negative and
past both ends, rows with the top byte set), on the raw containers' B=4
step with the most motion and over stream 0's B=1 steps; runs

  (h) lane, raw payload, dense, frames + ds2 model tensors;
  (i) lane, raw payload, still-elided (found by the containers' magic),
      frames + model tensors;
  (j) lane, rans payload, dense, frames + model tensors

(frames equal to the source frames on their low 24 bits).  The kmv_sparse
transport: kmv_sparse_compose (csrc/kmv_sparse.cu) against its twin on a
random B=4 1080p step (experiments/sparse_step.step_inputs: clamped edge
tiles overlapping the row above, indices that wrap or fall outside the
rows, wrapping vectors, an unchanged stream) and on the P-frame step with
the most tiles of the port's native sparse emission of the streams; runs

  (k) kmv_sparse, native branch, windows snapped to the keyframes (they
      lead windows and ship as the scans' dense init), frames + ds2 model
      tensors;
  (l) the same with sparse_lane_payload=True: the tiles rANS-coded on the
      host and decoded by rans_decode_packed, its ingest route.

The (dp, gop) mesh (jsplayer_tpu_torch.pipeline.mesh), every slot on
cuda:0, the hand kernels launched on every slot:

  (o) run (a)'s streams and configuration on a dp=2, gop=1 mesh (every
      window PADDED under a mesh), through the outmap timeline;
  (p) the same on the bc path (run (f)'s configuration);
  (q) streams 0 and 1 re-encoded with a keyframe every 32 frames, windows
      of 32, on a dp=2, gop=2 mesh: two keyframe-led windows a dispatch
      through kmv and bc, then the same streams as lane containers (raw
      and rans) grouped the same way, each equal to its unsharded run;
  (r) (after run (m)) run (m)'s streams on a dp=4 mesh, every window equal
      to run (m)'s;
  (s) a one-process NCCL group: the mesh's psum of run (o)'s significant
      frames through all_reduce, then the group destroyed;

and, after the MSV1 runs, jsplayer_tpu_torch.dryrun_multichip(4, "cuda").
Each mesh run logs its delivered fps beside its unsharded run's (a
reading: the slots share one card) and its hand kernels' launches, and
requires one launch a scan step a slot (a window a slot for msv1_paint),
so no step took a plain version.

MSVideo1: msv1_paint (csrc/msv1_paint.cu, one launch a window) against its
twin on a random B=8 CIF window of 64 steps, through its staged instance
(commands in shared memory ahead of the time loop), as in both runs

  (m) MSV1 16-bit CIF (352x288), B=8 x 128 frames;
  (n) MSV1 8-bit palettized 320x240 with MP3 tracks, B=8 x 128 frames,

both made by the port's encode/msv1_enc.py (a pool of 4 streams of
16-frame periods led by a keyframe: experiments/msv1_step), each pool
stream's frames decoded by the port's host oracle (codecs/msvideo1)
against their source first, then
every ingested frame against its source frame, every model tensor against
the plain epilogue and each window's significance against the twin's.
After the validate phase, rans_decode_aligned and rans_decode_packed (csrc/
rans_lanes.cu) against their twins at N=4096, B=4 on a dense 1080p window
(experiments/lane_step.dense_rans, encoded once) and on random u32
states, refills and lane bytes, each beside its chain bound (the time of
csrc/rans_lanes.cu's chain probe on the same inputs, itself held against
its twin) and the SM clock under load, then roundtrip_decode, the packed
decode's other route.  The aligned decode must take its staged instance
there, in run (j) and in the validate legs.  The validate phase runs
jsplayer_tpu_torch.validate's nine parity legs on the card.  Then phase
(e), the ds2 experiments (jsplayer_tpu_torch.experiments):
kmv_compose_ds2 (csrc/kmv_compose.cu's fused compose+ds2
instance) on random inputs and every mode of csrc/ds_probe.cu at its
script's full shape, each against its plain twin; then the experiments'
entry points: exp_model_fusion2's seven variants on the 1080p bench-mix
stream, all equal to variant A, and the three probe experiments.  Each
path runs with every launch count set to 0 just before it and read just
after; each kernel must have launched on its path.  Last, kmv_compose and
kmv_compose_ds2 scan the bench-mix stream's compacted B=1 steps (the
steps the CONCAT main path launches), bit-exact against the plain twins.
Every kernel's `ms` is CUDA events around calls through its wrapper; the
compose kernels and every ds_probe mode also give `graph_ms`, the same
calls replayed as a CUDA graph (device time without the host's launch
cost).  Every time stands beside its bound: the bytes the function must
move on this run's data over 3.35 TB/s; the B=1 scans add a DRAM-only
bound without the reads of prev, the step before's out, warm in L2; the
rANS decodes add Msym/s.
ds_probe's block_transpose mode also gives torch's own transpose copy
(`library_ms`, `library_graph_ms`) on a [4, 1024, 1920] input, its passthru
mode torch's strided-slice copy on [64, 1024, 1920], and its hpair_i32 and
wpair_i32 modes torch's add of two strided views on [4, 1024, 1920], each
beside the kernel's time there; the two pair modes and their adds are
timed there again with a cold L2 (a 256 MB write before each call).  The
row modes (passthru, hpair_i32, wpair_i32) must take their 16-byte
instances at both shapes and in the experiments' run, and passthru
must equal torch's slice copy (of the zero-padded frames at 1080 rows) bit
for bit.

Any failure raises (non-zero exit).  Without CUDA it exits 2 before doing
anything; without the repository around it the first import fails.  The
last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}};
the line before it is the card's `name, power.limit`, and before that a
JSON object with each kernel's launches, error, times and bound.  Imports
nothing of JAX and nothing of jsplayer_tpu, and checks that before its
last line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from jsplayer_tpu_torch.experiments.bc_step import motion_step as \
    bc_motion_step
from jsplayer_tpu_torch.experiments.bc_step import (step_inputs,
                                                    transport_args)
from jsplayer_tpu_torch.experiments.block_step import (B, T, X, Y,
                                                       motion_step,
                                                       screen_streams)
from jsplayer_tpu_torch.experiments.common import (HBM_BYTES_PER_MS,
                                                   bc_bytes, bc_data_pixels,
                                                   block_bytes, card_line,
                                                   graph_ms, io_bytes,
                                                   rand_frames, sm_clocks,
                                                   time_ms)

# the slice: block_step's captured streams, B=4 x T=128 frames, 1080p,
# keyframes at 0 and 40: windows [0,40) [40,104) CONCAT, [104,128) starts
# mid-GOP -> PADDED
WINDOW = 64
DEV = torch.device("cuda", 0)  # the one card the script needs
# runs (m) and (n): MSV1 16-bit CIF and 8-bit palettized 320x240 (BASELINE
# configs 1 and 2), MSV1_B streams of T frames each
MSV1_RUNS = (("m", 16, 352, 288), ("n", 8, 320, 240))
MSV1_B = 8


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def bound(nbytes: int) -> dict:
    """The bytes a call must move (each input read once, each output
    written once) → its least time on the card.  Every kernel here is bound
    by bytes: a few integer operations a word against 3.35 TB/s.  No single
    PyTorch call computes any of them (packed 10-bit field sums, per-pixel
    selects between payload and gathered prev, zero reads past a partial
    block), so library_ms is null."""
    return dict(bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_MS,
                bound_by="bytes", library_ms=None)


def kmv_bytes(pc, mvk, chg, red=None) -> int:
    """Bytes kmv steps must move on their data (pc [B, Y, X], one plane a
    stream): out written for every stream; an unchanged stream reads prev;
    a changed one reads its paycode word a pixel, and prev besides where
    that word is not data (ptype != 1); mvk and changed read; the ds2
    plane written."""
    data = int(sum(int((((pc[b] >> 24) & 3) == 1).sum())
                   for b in range(pc.shape[0]) if bool(chg[b])))
    words = pc[0].numel() * (2 * pc.shape[0] + int(chg.sum())) - data
    return (4 * words + io_bytes(mvk, chg)
            + (io_bytes(red) if red is not None else 0))


def step_report(name: str, what: str, card: str, ms: float, graph: float,
                plain_ms: float, nbytes: int, **extra) -> dict:
    """Log one compose kernel's times against its bound → its numbers:
    `ms` CUDA events around wrapper calls, as for every kernel; `graph_ms`
    the same calls replayed as a CUDA graph (device time without the
    host's launch cost)."""
    b = bound(nbytes)
    log(f"{name} {what}: kernel {ms:.4f} ms/step through the wrapper, "
        f"{graph:.4f} as a CUDA graph; plain {plain_ms:.4f} ms/step; "
        f"{nbytes} bytes, bound {b['bound_ms']:.4f} ms, "
        f"{100 * b['bound_ms'] / ms:.1f}% of bound (wrapper), "
        f"{100 * b['bound_ms'] / graph:.1f}% (graph) ({card})")
    return dict(ms=ms, graph_ms=graph, plain_ms=plain_ms, **b, **extra)


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
    from jsplayer_tpu_torch import native

    t0 = time.perf_counter()
    ok = native.available()
    log(f"jsplayer_tpu_torch.native.available(): {ok} "
        f"({time.perf_counter() - t0:.3f} s, g++ -> {native._LIB_PATH})")
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
        name = "?"
        for line in info["log"].splitlines():
            if "Compiling entry function" in line:
                name = kernel_name(line)
            elif "registers" in line or "spill" in line or "error" in line:
                log(f"  ptxas: {name}: {line.strip()}")


def kernel_name(line: str) -> str:
    """A kernel's name in ptxas's `Compiling entry function '<mangled>'`
    line: the name after the source file's namespace, with its template
    arguments as the mangled tail (`ILb1E`), else the mangled name."""
    import re

    mangled = line.split("'")[1] if "'" in line else line
    m = re.search(r"_cu_[0-9a-f]{8}(\d+)", mangled)
    if not m:
        return mangled
    n = int(m.group(1))
    name = mangled[m.end():m.end() + n]
    tail = re.match(r"I(\w+?)E", mangled[m.end() + n:])
    return name + (f"<{tail.group(1)}>" if tail else "")


def phase_kernels(card: str) -> dict:
    from jsplayer_tpu_torch.experiments.kmv_step import compose_inputs
    from jsplayer_tpu_torch.kernels.rgb_convert import ds2_pack, ds2_pack_ref
    from jsplayer_tpu_torch.kernels.sp_recon import kmv_compose, kmv_compose_ref

    rng = np.random.default_rng(0)
    res = {}

    # kmv_compose: B=4, K=2, every ptype and kslot, wrapping vectors, one
    # unchanged stream
    prev, pc, mvk, chg = compose_inputs(DEV)
    got = kmv_compose(prev, pc, mvk, chg)
    want = kmv_compose_ref(prev, pc, mvk, chg)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    require(torch.equal(got, want), "kmv_compose bit-exact vs plain")
    out = torch.empty_like(prev)

    def step():
        kmv_compose(prev, pc, mvk, chg, out=out)

    res["kmv_compose"] = dict(max_abs_err=err, **step_report(
        "kmv_compose", f"{list(prev.shape)} K={mvk.shape[1]} random step, "
        f"bit-exact", card, time_ms(step), graph_ms(step),
        time_ms(lambda: kmv_compose_ref(prev, pc, mvk, chg)),
        kmv_bytes(pc, mvk, chg)))
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
            times[(shape, flip)] = (ms, plain_ms, io_bytes(fr, got))
            log(f"ds2_pack {list(shape)} flip={flip}: bit-exact; kernel "
                f"{ms:.4f} ms/call, plain {plain_ms:.4f} ms/call ({card})")
        del fr, got, want
    ms, plain_ms, nbytes = times[((64, Y, X), False)]
    res["ds2_pack"] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                           **bound(nbytes))
    return res


def run_ingest(avis, still_elision=True, window=WINDOW, **kw):
    """Drive the port's pipeline once → (window dicts, stats, seconds)."""
    from jsplayer_tpu_torch import IngestConfig, MemorySource, VideoIngestPipeline

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe = VideoIngestPipeline(
        [MemorySource(a) for a in avis],
        IngestConfig(window=window, still_elision=still_elision,
                     model_downscale=2, device=str(DEV), **kw))
    batches = list(pipe)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    require(not pipe.quarantined, f"no stream quarantined "
            f"({pipe.quarantine_errors})")
    # the lane path keeps no elision-layout stats (as the reference)
    return batches, dict(getattr(pipe, "stats", {})), dt


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
    from jsplayer_tpu_torch.kernels.lane_recon import lane_compose
    from jsplayer_tpu_torch.kernels.rans_lanes import (rans_decode_aligned,
                                                       rans_decode_packed)
    from jsplayer_tpu_torch.kernels.rgb_convert import ds2_pack
    from jsplayer_tpu_torch.kernels.sp_motion_mxu import sp_motion_mxu
    from jsplayer_tpu_torch.kernels.sp_motion_pallas import sp_motion_patch
    from jsplayer_tpu_torch.kernels.msv1_paint import msv1_paint
    from jsplayer_tpu_torch.kernels.sp_recon import (bc_compose, kmv_compose,
                                                     kmv_compose_ds2,
                                                     kmv_sparse_compose,
                                                     sp_compose_general)

    return {"kmv_compose": kmv_compose, "ds2_pack": ds2_pack,
            "sp_compose_general": sp_compose_general,
            "sp_motion_patch": sp_motion_patch,
            "sp_motion_mxu": sp_motion_mxu,
            "kmv_compose_ds2": kmv_compose_ds2, "ds_probe": ds_probe,
            "bc_compose": bc_compose, "lane_compose": lane_compose,
            "rans_decode_aligned": rans_decode_aligned,
            "rans_decode_packed": rans_decode_packed,
            "kmv_sparse_compose": kmv_sparse_compose,
            "msv1_paint": msv1_paint}


def count_launches(fn):
    """Run fn() with every kernel's launch count set to 0 just before it →
    (fn's result, {kernel: launches during fn}); ds_probe's launches per
    mode under "ds_probe_modes", and per instance of ds_probe's row modes
    (passthru, hpair_i32: {mode: {instance: launches}}),
    rans_decode_aligned and msv1_paint under "ds_probe_instances",
    "rans_aligned_instances" and "msv1_instances"."""
    from jsplayer_tpu_torch.kernels.ds_probe import ds_probe
    from jsplayer_tpu_torch.kernels.msv1_paint import msv1_paint
    from jsplayer_tpu_torch.kernels.rans_lanes import rans_decode_aligned

    counters = kernel_counters()
    for w in counters.values():
        w.launches = 0
    ds_probe.by_mode.clear()
    ds_probe.by_instance.clear()
    rans_decode_aligned.by_instance.clear()
    msv1_paint.by_instance.clear()
    res = fn()
    got = {name: w.launches for name, w in counters.items()}
    got["ds_probe_modes"] = dict(ds_probe.by_mode)
    got["ds_probe_instances"] = {m: dict(c) for m, c in
                                 ds_probe.by_instance.items()}
    got["rans_aligned_instances"] = dict(rans_decode_aligned.by_instance)
    got["msv1_instances"] = dict(msv1_paint.by_instance)
    return res, got


def require_staged(launches, what):
    """Every rans_decode_aligned launch in a run took the staged instance."""
    inst = launches["rans_aligned_instances"]
    require(inst.get("staged", 0) == launches["rans_decode_aligned"] > 0,
            f"{what}: rans_decode_aligned ran its staged instance ({inst})")


def require_only(launches, kernels, what):
    """Each of `kernels` launched in a run and no other compose did."""
    require(all(launches[k] > 0 for k in kernels),
            f"{what} launched {kernels} ({launches})")
    require(sum(v for k, v in launches.items()
                if k not in kernels and not isinstance(v, dict)) == 0,
            f"{what} launched no other kernel ({launches})")


def capture(chunks):
    """The native decoder's capture of the streams → torch tensors on the
    card: bts [B,T,NB], mv [B,T,NB,2], rect [B,T,NB,4], payload
    [B,T,Y,X] int32 bits, changed [B,T] bool."""
    from jsplayer_tpu_torch import native

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
    t = motion_step(cap["bts"], cap["changed"])
    n3 = int((cap["bts"][:, t] == 3).sum())
    require(t > 0 and bool(cap["changed"][:, t].all()) and n3 > 0,
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
    log(f"block kernels at step {t}: {n3} bts-3 blocks over {B} "
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

        def call():
            step(prev, *args, chg, out=out)

        res[name] = dict(max_abs_err=err, **step_report(
            name, f"[{B},{Y},{X}] {what} step, bit-exact", card,
            time_ms(call), graph_ms(call),
            time_ms(lambda: P.per_stream_ref(ref, prev, chg, *args)),
            block_bytes(name, prev, args, chg)))
    return res


def phase_block_scan(card: str, cap: dict, src) -> dict:
    """Each sp_motion.cu mode on B=1 1080p steps: stream 0's capture
    scanned from a zero frame (prev is the step before's out; an unchanged
    step launches with changed False), every frame equal to the source
    frame and to the plain twin's scan → {kernel: numbers per step}.
    Beside the bound on the function's bytes, dram_bound_ms leaves out the
    reads of prev, warm in the 50 MB L2."""
    from jsplayer_tpu_torch.kernels import sp_motion_mxu as PM
    from jsplayer_tpu_torch.kernels import sp_motion_pallas as PP
    from jsplayer_tpu_torch.kernels import sp_recon as P

    cmds = [cap[k][0] for k in ("bts", "mv", "rect", "payload")]
    chg = cap["changed"][0]
    mxu = [torch.stack(c) for c in zip(*(
        PM.mxu_commands(*(c[t] for c in cmds)) for t in range(T)))]
    frames = torch.empty((T, Y, X), dtype=torch.int32, device=DEV)
    init = torch.zeros((1, Y, X), dtype=torch.int32, device=DEV)
    res = {}
    for name, step, ref, args in (
            ("sp_compose_general", P.sp_compose_general, P.compose_frame_ref,
             cmds),
            ("sp_motion_patch", PP.sp_motion_patch, PP.compose_frame_fast_ref,
             cmds),
            ("sp_motion_mxu", PM.sp_motion_mxu, PM.compose_frame_mxu_ref,
             mxu)):
        def scan():
            prev = init
            for t in range(T):
                step(prev, *(a[t:t + 1] for a in args), chg[t:t + 1],
                     out=frames[t:t + 1])
                prev = frames[t:t + 1]
            return frames

        def plain_scan():
            prev, outs = init, []
            for t in range(T):
                prev = P.per_stream_ref(ref, prev, chg[t:t + 1],
                                        *(a[t:t + 1] for a in args))
                outs.append(prev)
            return torch.cat(outs)

        frames.fill_(0x7EADBEEF)
        got = scan()
        want = plain_scan()
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        require(torch.equal(got, want),
                f"{name} B=1 scan of stream 0 bit-exact vs plain")
        require(torch.equal(got, src[0].to(DEV)),
                f"{name} B=1 scan of stream 0: every frame == source frame")
        del want
        nbytes = [block_bytes(name, init, [a[t:t + 1] for a in args],
                              chg[t:t + 1], dram=dram)
                  for dram in (False, True) for t in range(T)]
        dram = bound(sum(nbytes[T:]))["bound_ms"] / T
        res[name] = dict(steps=T, max_abs_err=err, **step_report(
            name, f"[1,{Y},{X}] stream 0 scan, {T} steps, bit-exact", card,
            time_ms(scan, iters=5) / T,
            graph_ms(scan, iters=1, replays=10) / T,
            time_ms(plain_scan, iters=2, warmup=1) / T,
            sum(nbytes[:T]) // T, dram_bound_ms=dram))
        log(f"{name} B=1 scan: DRAM-only bound {dram:.4f} ms/step, "
            f"{100 * dram / res[name]['graph_ms']:.1f}% (graph)")
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
        FPS[name] = B * T / dt
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
    require_only(launches, (kernel, "ds2_pack"), f"run ({name})")
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
# The bc transport: bc_compose, runs (f) and (g)

def outside_data_flipped(plane, bcode, rloc):
    """plane with every word outside the code-1 rects inverted."""
    Bn, Yn, Xn = plane.shape
    keep = torch.stack([bc_data_pixels(bcode[b], rloc[b], Yn, Xn)
                        for b in range(Bn)])
    return torch.where(keep, plane, ~plane)


def phase_bc_kernel(card: str) -> dict:
    """bc_compose against its twin on random B=4 1080p inputs, bit for bit;
    the plane's words outside the data rects are random, and a second call
    with them inverted must give the same frames."""
    from jsplayer_tpu_torch.kernels.sp_recon import bc_compose, bc_compose_ref

    prev, args, chg = step_inputs(DEV)
    got = bc_compose(prev, *args, chg)
    want = bc_compose_ref(prev, *args, chg)
    flipped = bc_compose(prev, outside_data_flipped(*args[:3]), *args[1:],
                         chg)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    require(torch.equal(got, want), "bc_compose bit-exact vs plain")
    require(torch.equal(flipped, got), "bc_compose reads no plane word "
            "outside a code-1 rect")
    out = torch.empty_like(prev)

    def step():
        bc_compose(prev, *args, chg, out=out)

    return dict(max_abs_err=err, **step_report(
        "bc_compose", f"[{B},{Y},{X}] K=2 random step, bit-exact", card,
        time_ms(step), graph_ms(step),
        time_ms(lambda: bc_compose_ref(prev, *args, chg)),
        bc_bytes(prev, args, chg)))


def bc_capture(chunks) -> dict:
    """The native decoder's bc transport of the streams (numpy, on the
    host): plane [B,T,Y,X] u32 (only data-rect words defined), bcode, rloc,
    mvk, changed."""
    from jsplayer_tpu_torch import native

    t0 = time.perf_counter()
    got = native.native_sp_decode_streams_bc(chunks, X, Y, K=2)
    require(not got["errors"], f"native bc decode ({got['errors']} errors)")
    log(f"native bc transport of {len(chunks)} x {len(chunks[0])} frames: "
        f"{time.perf_counter() - t0:.3f} s")
    return got


def phase_bc_step(card: str, bc: dict, src) -> dict:
    """bc_compose on the native transport's B=4 step with the most motion
    blocks (every stream changed), against its twin and the source
    frames."""
    from jsplayer_tpu_torch.kernels.sp_recon import bc_compose, bc_compose_ref

    t = bc_motion_step(bc)
    require(t > 0 and bool(bc["changed"][:, t].all()),
            "a bc step with every stream changed")
    prev = torch.stack([s[t - 1] for s in src]).to(DEV)
    args = transport_args(bc, slice(None), t, DEV)
    chg = torch.ones(B, dtype=torch.bool, device=DEV)
    got = bc_compose(prev, *args, chg)
    want = bc_compose_ref(prev, *args, chg)
    torch.cuda.synchronize()
    require(torch.equal(got, want), "bc_compose captured step bit-exact vs "
            "plain")
    require(torch.equal(got, torch.stack([s[t] for s in src]).to(DEV)),
            "bc_compose captured step composes the source frames")
    out = torch.empty_like(prev)

    def step():
        bc_compose(prev, *args, chg, out=out)

    n = int((bc["bcode"][:, t] >= 2).sum())
    return dict(step=t, **step_report(
        "bc_compose", f"[{B},{Y},{X}] captured step {t} ({n} motion "
        f"blocks), bit-exact", card, time_ms(step), graph_ms(step),
        time_ms(lambda: bc_compose_ref(prev, *args, chg)),
        bc_bytes(prev, args, chg)))


def phase_bc_scan(card: str, bc: dict, src) -> dict:
    """bc_compose over stream 0's B=1 1080p steps of the native bc
    transport, scanned from a zero frame (an unchanged step launches with
    changed False): every frame equal to the source frame and to the plain
    twin's scan → numbers per step, with the DRAM-only bound beside the
    full one (prev, the step before's out, warm in the 50 MB L2)."""
    from jsplayer_tpu_torch.kernels.sp_recon import bc_compose, bc_compose_ref

    args = transport_args(bc, 0, slice(None), DEV)
    chg = torch.from_numpy(bc["changed"][0]).to(DEV)
    frames = torch.empty((T, Y, X), dtype=torch.int32, device=DEV)
    init = torch.zeros((1, Y, X), dtype=torch.int32, device=DEV)

    def scan():
        prev = init
        for t in range(T):
            bc_compose(prev, *(a[t:t + 1] for a in args), chg[t:t + 1],
                       out=frames[t:t + 1])
            prev = frames[t:t + 1]
        return frames

    def plain_scan():
        prev, outs = init, []
        for t in range(T):
            prev = bc_compose_ref(prev, *(a[t:t + 1] for a in args),
                                  chg[t:t + 1])
            outs.append(prev)
        return torch.cat(outs)

    frames.fill_(0x7EADBEEF)
    got = scan()
    want = plain_scan()
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    require(torch.equal(got, want), "bc_compose B=1 scan of stream 0 "
            "bit-exact vs plain")
    require(torch.equal(got, src[0].to(DEV)), "bc_compose B=1 scan of "
            "stream 0: every frame == source frame")
    del want
    nbytes = [bc_bytes(init, [a[t:t + 1] for a in args], chg[t:t + 1],
                       dram=dram) for dram in (False, True) for t in range(T)]
    dram = bound(sum(nbytes[T:]))["bound_ms"] / T
    res = dict(steps=T, max_abs_err=err, **step_report(
        "bc_compose", f"[1,{Y},{X}] stream 0 scan, {T} steps, bit-exact",
        card, time_ms(scan, iters=5) / T,
        graph_ms(scan, iters=1, replays=10) / T,
        time_ms(plain_scan, iters=2, warmup=1) / T,
        sum(nbytes[:T]) // T, dram_bound_ms=dram))
    log(f"bc_compose B=1 scan: DRAM-only bound {dram:.4f} ms/step, "
        f"{100 * dram / res['graph_ms']:.1f}% (graph)")
    return res


def phase_bc_runs(card: str, avis, src, models) -> dict:
    """Runs (f) and (g): sp_device_path "bc", (f) still-elided with frames
    and ds2 model tensors (CONCAT and PADDED windows), (g) dense and model
    tensors only; every frame equal to its source frame and every model
    tensor to the plain epilogue."""
    (bf, stats, dt), launches_f = count_launches(
        lambda: run_ingest(avis, sp_device_path="bc"))
    FPS["f"] = B * T / dt
    log(f"run (f) bc: {stats}; {B * T} timeline frames in {dt:.3f} s = "
        f"{B * T / dt:.1f} delivered frames/s ({card}); launches "
        f"{launches_f}")
    require(stats["concat_windows"] > 0 and stats["padded_windows"] > 0,
            f"run (f) ran both elision layouts ({stats})")
    require_only(launches_f, ("bc_compose", "ds2_pack"), "run (f)")
    for b in range(B):
        rows = timeline_rows(bf, b)
        require(torch.equal(gather(bf, rows, "frames_u32"), src[b].to(DEV)),
                f"run (f) stream {b} frames == source frames")
        check_model(gather(bf, rows, "model_input"), models[b],
                    f"run (f) stream {b}")
    log("run (f): every stream's frames and model tensors bit-exact")
    del bf

    (bg, _, dt), launches_g = count_launches(
        lambda: run_ingest(avis, still_elision=False, sp_device_path="bc",
                           emit_frames=False))
    log(f"run (g) bc model-only: {len(bg)} windows, {B * T} frames in "
        f"{dt:.3f} s = {B * T / dt:.1f} delivered frames/s ({card}); "
        f"launches {launches_g}")
    require_only(launches_g, ("bc_compose", "ds2_pack"), "run (g)")
    require(all("frames_u32" not in w for w in bg), "run (g) emits no frame "
            "stack")
    for w in bg:
        t0, n = w["start_frame"], w["model_input"].shape[1]
        for b in range(B):
            check_model(w["model_input"][b], models[b][t0:t0 + n],
                        f"run (g) stream {b} window @{t0}")
    require(sum(w["model_input"].shape[1] for w in bg) == T,
            f"run (g) covers {T} frames")
    log("run (g): every stream's model tensors bit-exact")
    return {k: launches_f[k] + launches_g[k] for k in ("bc_compose",
                                                       "ds2_pack")}


# ---------------------------------------------------------------------------
# The lane path: lane_compose, the rANS decodes, runs (h), (i) and (j)

def require24(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    """got equals want on the low 24 bits of every word (the lane path's
    frames, as scripts/tpu_validate.py compares them)."""
    require(got.shape == want.shape
            and torch.equal(got & 0xFFFFFF, want & 0xFFFFFF), what)


def lane_containers(avis) -> dict:
    """The streams transcoded by the port's transcode_to_lane(window=64,
    K=2), each stream in a thread, raw and rans payloads → {payload:
    [container bytes]}; the seconds are logged apart from every run."""
    from concurrent.futures import ThreadPoolExecutor

    from jsplayer_tpu_torch import transcode_to_lane

    out = {}
    for payload in ("raw", "rans"):
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(avis)) as ex:
            out[payload] = list(ex.map(lambda a: transcode_to_lane(
                a, window=WINDOW, K=2, payload=payload), avis))
        log(f"transcode_to_lane ({payload}) of {len(avis)} x {T} frames, "
            f"{len(avis)} threads: {time.perf_counter() - t0:.3f} s, "
            f"{sum(map(len, out[payload]))} container bytes")
    return out


def phase_lane_kernel(card: str) -> dict:
    """lane_compose against its twin on the random B=4 1080p step
    (experiments/lane_step.step_inputs: wrapping vectors, codes past 2+K,
    stream 2 unchanged, row indices negative and past both ends, rows with
    the top byte set), bit for bit."""
    from jsplayer_tpu_torch.experiments.lane_step import (lane_bytes,
                                                          step_inputs)
    from jsplayer_tpu_torch.kernels.lane_recon import (lane_compose,
                                                       lane_compose_ref)

    prev, args, chg = step_inputs(DEV)
    got = lane_compose(prev, *args, chg)
    want = lane_compose_ref(prev, *args, chg)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    require(torch.equal(got, want), "lane_compose bit-exact vs plain")
    out = torch.empty_like(prev)

    def step():
        lane_compose(prev, *args, chg, out=out)

    return dict(max_abs_err=err, **step_report(
        "lane_compose", f"[{B},{Y},{X}] K=2 random step, Ur="
        f"{args[0].shape[1]}, bit-exact", card, time_ms(step),
        graph_ms(step), time_ms(lambda: lane_compose_ref(prev, *args, chg)),
        lane_bytes(prev, args, chg)))


def lane_windows(conts) -> list:
    """The raw containers parsed → for each window: (its first frame, rows
    [B, Ur, X] on the card (the [:, :, :X] view of the unit gather, Ur
    padded to the batch's largest), {row_idx [B, T, Y], btype, rect, mvk,
    changed [B, T]} on the card).  The streams share window boundaries."""
    from jsplayer_tpu_torch.codecs import lane_format
    from jsplayer_tpu_torch.kernels.lane_recon import rows_batch, \
        units_from_raw

    cs = [lane_format.container_from_bytes(c) for c in conts]
    ncol = lane_format.plane_cols(X) // 128
    out, base = [], 0
    for wi in range(len(cs[0].windows)):
        ws = [c.windows[wi] for c in cs]
        idx = [w.row_index(Y, ncol) for w in ws]
        Ur = max(rt.shape[0] for rt, _ in idx)
        U = max(w.n_units for w in ws)
        table = np.zeros((len(ws), Ur, ncol), np.int32)
        payload = np.zeros((len(ws), U, 3, 128), np.uint8)
        for b, (w, (rt, _)) in enumerate(zip(ws, idx)):
            table[b, : rt.shape[0]] = rt
            payload[b, : w.n_units] = w.payload
        rows = rows_batch(units_from_raw(torch.from_numpy(payload).to(DEV)),
                          torch.from_numpy(table).to(DEV), X)
        cmds = {k: torch.from_numpy(np.ascontiguousarray(np.stack(a))).to(DEV)
                for k, a in (("row_idx", [ri for _, ri in idx]),
                             ("btype", [w.btype for w in ws]),
                             ("rect", [w.rect for w in ws]),
                             ("mvk", [w.mvk for w in ws]),
                             ("changed", [w.changed for w in ws]))}
        out.append((base, rows, cmds))
        base += ws[0].T
    require(base == T, f"the lane windows tile {T} frames")
    return out


def lane_step_args(rows, cmds, t, b=slice(None)):
    """lane_compose's arguments after prev at step t of a window."""
    return [rows[b], cmds["row_idx"][b, t], cmds["btype"][b, t],
            cmds["rect"][b, t], cmds["mvk"][b, t]]


def phase_lane_step(card: str, windows, src) -> dict:
    """lane_compose on the captured B=4 step with the most motion blocks
    (every stream changed) of the raw containers, against its twin and the
    source frames."""
    from jsplayer_tpu_torch.experiments.lane_step import lane_bytes
    from jsplayer_tpu_torch.kernels.lane_recon import (lane_compose,
                                                       lane_compose_ref)

    best = None
    for wi, (base, _, cmds) in enumerate(windows):
        ok = cmds["changed"].all(dim=0)
        n = torch.where(ok, (cmds["btype"] >= 2).sum(dim=(0, 2)), -1)
        if base == 0:
            n[0] = -1
        t = int(n.argmax())
        if best is None or int(n[t]) > best[0]:
            best = (int(n[t]), wi, t)
    n, wi, t = best
    base, rows, cmds = windows[wi]
    require(n >= 0, "a lane step with every stream changed")
    prev = torch.stack([s[base + t - 1] for s in src]).to(DEV)
    args = lane_step_args(rows, cmds, t)
    chg = torch.ones(B, dtype=torch.bool, device=DEV)
    got = lane_compose(prev, *args, chg)
    want = lane_compose_ref(prev, *args, chg)
    torch.cuda.synchronize()
    require(torch.equal(got, want), "lane_compose captured step bit-exact "
            "vs plain")
    require24(got, torch.stack([s[base + t] for s in src]).to(DEV),
              "lane_compose captured step composes the source frames")
    out = torch.empty_like(prev)

    def step():
        lane_compose(prev, *args, chg, out=out)

    return dict(step=base + t, **step_report(
        "lane_compose", f"[{B},{Y},{X}] captured step {base + t} ({n} "
        f"motion blocks, Ur={rows.shape[1]}), bit-exact", card,
        time_ms(step), graph_ms(step),
        time_ms(lambda: lane_compose_ref(prev, *args, chg)),
        lane_bytes(prev, args, chg)))


def phase_lane_scan(card: str, windows, src) -> dict:
    """lane_compose over stream 0's B=1 1080p steps of the raw container,
    window by window from a zero frame (an unchanged step launches with
    changed False), every frame equal to the source frame and to the plain
    twin's scan → numbers per step, with the DRAM-only bound beside the
    full one (prev, the step before's out, warm in the 50 MB L2)."""
    from jsplayer_tpu_torch.experiments.lane_step import lane_bytes
    from jsplayer_tpu_torch.kernels.lane_recon import (lane_compose,
                                                       lane_compose_ref)

    steps = [(base + t, [a[0:1] for a in lane_step_args(rows, cmds, t)],
              cmds["changed"][0:1, t])
             for base, rows, cmds in windows
             for t in range(cmds["changed"].shape[1])]
    frames = torch.empty((T, Y, X), dtype=torch.int32, device=DEV)
    init = torch.zeros((1, Y, X), dtype=torch.int32, device=DEV)

    def scan():
        prev = init
        for g, args, chg in steps:
            lane_compose(prev, *args, chg, out=frames[g:g + 1])
            prev = frames[g:g + 1]
        return frames

    def plain_scan():
        prev, outs = init, []
        for _, args, chg in steps:
            prev = lane_compose_ref(prev, *args, chg)
            outs.append(prev)
        return torch.cat(outs)

    frames.fill_(0x7EADBEEF)
    got = scan()
    want = plain_scan()
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    require(torch.equal(got, want), "lane_compose B=1 scan of stream 0 "
            "bit-exact vs plain")
    require24(got, src[0].to(DEV), "lane_compose B=1 scan of stream 0: "
              "every frame == source frame")
    del want
    nbytes = [lane_bytes(init, args, chg, dram=dram)
              for dram in (False, True) for _, args, chg in steps]
    dram = bound(sum(nbytes[T:]))["bound_ms"] / T
    res = dict(steps=T, max_abs_err=err, **step_report(
        "lane_compose", f"[1,{Y},{X}] stream 0 scan, {T} steps, bit-exact",
        card, time_ms(scan, iters=5) / T,
        graph_ms(scan, iters=1, replays=10) / T,
        time_ms(plain_scan, iters=2, warmup=1) / T,
        sum(nbytes[:T]) // T, dram_bound_ms=dram))
    log(f"lane_compose B=1 scan: DRAM-only bound {dram:.4f} ms/step, "
        f"{100 * dram / res['graph_ms']:.1f}% (graph)")
    return res


def phase_lane_runs(card: str, conts, src, models) -> dict:
    """Runs (h) raw dense, (i) raw still-elided (found by the containers'
    magic, without sp_device_path) and (j) rans dense, each with frames and
    ds2 model tensors: every frame equal to its source frame (low 24 bits)
    and every model tensor to the plain epilogue → {kernel: launches over
    the three runs}."""
    total = {}
    for name, payload, elide, kw in (
            ("h", "raw", False, dict(sp_device_path="lane")),
            ("i", "raw", True, {}),
            ("j", "rans", False, dict(sp_device_path="lane"))):
        (batches, _, dt), launches = count_launches(
            lambda: run_ingest(conts[payload], still_elision=elide, **kw))
        log(f"run ({name}) lane {payload}{' elided' if elide else ''}: "
            f"{len(batches)} windows, {B * T} timeline frames in {dt:.3f} s "
            f"= {B * T / dt:.1f} delivered frames/s, transcode excluded "
            f"({card}); launches {launches}")
        require_only(launches, ("lane_compose", "ds2_pack")
                     + (("rans_decode_aligned",) if payload == "rans"
                        else ()), f"run ({name})")
        if payload == "rans":
            require_staged(launches, f"run ({name})")
        for k, v in launches.items():
            if not isinstance(v, dict):
                total[k] = total.get(k, 0) + v
        if elide:
            for b in range(B):
                rows = timeline_rows(batches, b)
                require24(gather(batches, rows, "frames_u32"),
                          src[b].to(DEV), f"run ({name}) stream {b} frames "
                          f"== source frames")
                check_model(gather(batches, rows, "model_input"), models[b],
                            f"run ({name}) stream {b}")
        else:
            for w in batches:
                t0, n = w["start_frame"], w["frames_u32"].shape[1]
                for b in range(B):
                    require24(w["frames_u32"][b], src[b][t0:t0 + n].to(DEV),
                              f"run ({name}) stream {b} window @{t0} frames "
                              f"== source frames")
                    check_model(w["model_input"][b], models[b][t0:t0 + n],
                                f"run ({name}) stream {b} window @{t0}")
            require(sum(w["frames_u32"].shape[1] for w in batches) == T,
                    f"run ({name}) covers {T} frames")
        log(f"run ({name}): every stream's frames and model tensors "
            f"bit-exact")
        del batches
    return total


# ---------------------------------------------------------------------------
# The (dp, gop) mesh: runs (o)-(r), the one-process NCCL psum (s), the dry
# run.  Every slot is cuda:0 (the script needs one card), so the slots run
# one after another: delivered fps beside the unsharded run is a reading
# only.

#: run name → delivered frames/s, the unsharded runs the mesh runs stand by
FPS: dict = {}
#: the hand kernels the mesh paths launch, whose counts each mesh run logs
MESH_KERNELS = ("kmv_compose", "ds2_pack", "bc_compose", "lane_compose",
                "rans_decode_aligned", "msv1_paint")
Q_WINDOW = 32  # run (q): keyframes every 32 frames, windows of 32


def card_mesh(dp: int, gop: int):
    """A (dp, gop) mesh whose every slot is the card."""
    from jsplayer_tpu_torch.pipeline.mesh import make_mesh

    return make_mesh(dp=dp, gop=gop, devices=[DEV] * (dp * gop))


def log_mesh_run(card, name, what, n_windows, frames, dt, ref, launches):
    FPS[name] = frames / dt
    log(f"run ({name}) {what}: {n_windows} windows, {frames} timeline "
        f"frames in {dt:.3f} s = {frames / dt:.1f} delivered frames/s beside "
        f"{FPS[ref]:.1f} unsharded (run ({ref}); a reading: every slot is "
        f"one card) ({card}); hand-kernel launches "
        + ", ".join(f"{k} {launches[k]}" for k in MESH_KERNELS))


def require_launches(launches, want: dict, what: str) -> None:
    """Each kernel of `want` launched exactly that often — one launch a scan
    step a slot (a window a slot for msv1_paint), so no step took a plain
    version — and no other compose kernel launched."""
    got = {k: launches[k] for k in want}
    require(got == want, f"{what} kernel launches {got} == {want}")
    require_only(launches, tuple(want), what)


def phase_mesh_dp(card: str, avis, src, models) -> tuple[dict, torch.Tensor]:
    """Runs (o) kmv and (p) bc: runs (a)'s and (f)'s streams and
    configuration (still-elided, frames and ds2 model tensors) on a dp=2,
    gop=1 mesh of cuda:0 slots.  Under a mesh every window takes the
    PADDED layout; through the outmap timeline every frame equals its
    source frame and every model tensor the plain epilogue, as in runs (a)
    and (f), so the two equal each other → ({run: launches}, (o)'s count
    of significant frames on the card)."""
    mesh = card_mesh(2, 1)
    res, sig = {}, None
    for name, ref, path, kernel in (("o", "a", "kmv", "kmv_compose"),
                                    ("p", "f", "bc", "bc_compose")):
        (batches, stats, dt), launches = count_launches(
            lambda: run_ingest(avis, sp_device_path=path, mesh=mesh))
        log_mesh_run(card, name, f"{path} on a dp=2 mesh, {stats}",
                     len(batches), B * T, dt, ref, launches)
        require(stats == {"concat_windows": 0,
                          "padded_windows": len(batches)},
                f"run ({name}) every window PADDED under a mesh ({stats})")
        rows = [w["frames_u32"].shape[0] for w in batches]
        require_launches(launches, {kernel: sum(2 * r // B for r in rows),
                                    "ds2_pack": sum(r > 0 for r in rows)},
                         f"run ({name})")
        for b in range(B):
            tl = timeline_rows(batches, b)
            require(torch.equal(gather(batches, tl, "frames_u32"),
                                src[b].to(DEV)),
                    f"run ({name}) stream {b} frames == source frames")
            check_model(gather(batches, tl, "model_input"), models[b],
                        f"run ({name}) stream {b}")
        log(f"run ({name}): every stream's frames and model tensors "
            f"bit-exact, as run ({ref})")
        if name == "o":
            sig = torch.stack([w["significant"].sum() for w in batches]).sum()
        res[name] = launches
        del batches
    return res, sig


def keyframe_avis(frames):
    """The streams' source frames encoded by the native encoder with a
    keyframe every Q_WINDOW frames, a thread a stream → AVI bytes."""
    from concurrent.futures import ThreadPoolExecutor

    from jsplayer_tpu_torch import native
    from jsplayer_tpu_torch.encode.avi_mux import mux_avi

    def encode(f):
        enc = native.NativeScreenPressorEncoder(4, X, Y)
        keys = [t % Q_WINDOW == 0 for t in range(T)]
        chunks = [enc.encode_i(x.reshape(-1)) if k
                  else enc.encode_p(x.reshape(-1)) for x, k in zip(f, keys)]
        return mux_avi(chunks, X, Y, 24, codec="SPV4", keyflags=keys)

    with ThreadPoolExecutor(len(frames)) as ex:
        return list(ex.map(encode, frames))


def on_timeline(batches, key):
    """Dense windows → their `key` tensors joined along time [B, T, ...]."""
    return torch.cat([w[key] for w in batches], dim=1)


def phase_mesh_gop(card: str, frames, src, models) -> dict:
    """Run (q): streams 0 and 1 re-encoded with a keyframe every 32 frames
    (B=2 x 128 1080p frames), windows of 32, dense, frames and ds2 model
    tensors, on a dp=2, gop=2 mesh of cuda:0 slots: G=2 keyframe-led
    windows a dispatch through kmv and bc, then the same streams
    transcoded to lane containers (raw and rans, window=32: every window a
    restart) grouped the same way.  Each equals its unsharded run (which
    runs first, for its fps), and the source frames (lane: low 24 bits)
    and the plain epilogue → {path: launches}."""
    from concurrent.futures import ThreadPoolExecutor

    from jsplayer_tpu_torch import transcode_to_lane

    t0 = time.perf_counter()
    avis = keyframe_avis(frames[:2])
    with ThreadPoolExecutor(4) as ex:
        conts = {p: list(ex.map(lambda a: transcode_to_lane(
            a, window=Q_WINDOW, K=2, payload=p), avis))
            for p in ("raw", "rans")}
    log(f"run (q) streams: 2 x {T} frames, keyframes every {Q_WINDOW}, "
        f"encoded and transcoded in {time.perf_counter() - t0:.3f} s")
    mesh, Bq = card_mesh(2, 2), 2
    groups = T // Q_WINDOW // 2  # dispatches of G=2 windows
    steps = groups * 4 * Q_WINDOW  # 4 slots, one window a slot
    res = {}
    for name, sources, kw, want in (
            ("q kmv", avis, dict(sp_device_path="kmv"),
             {"kmv_compose": steps, "ds2_pack": T // Q_WINDOW}),
            ("q bc", avis, dict(sp_device_path="bc"),
             {"bc_compose": steps, "ds2_pack": T // Q_WINDOW}),
            ("q lane raw", conts["raw"], dict(sp_device_path="lane"),
             {"lane_compose": steps, "ds2_pack": groups}),
            ("q lane rans", conts["rans"], dict(sp_device_path="lane"),
             {"lane_compose": steps, "ds2_pack": groups,
              "rans_decode_aligned": groups * 4})):
        plain, _, dt0 = run_ingest(sources, still_elision=False,
                                   window=Q_WINDOW, **kw)
        FPS[name + " unsharded"] = Bq * T / dt0
        (batches, _, dt), launches = count_launches(
            lambda: run_ingest(sources, still_elision=False,
                               window=Q_WINDOW, mesh=mesh, **kw))
        log_mesh_run(card, name, "on a dp=2, gop=2 mesh", len(batches),
                     Bq * T, dt, name + " unsharded", launches)
        require_launches(launches, want, f"run ({name})")
        if "rans_decode_aligned" in want:
            require_staged(launches, f"run ({name})")
        fr = on_timeline(batches, "frames_u32")
        require(torch.equal(fr, on_timeline(plain, "frames_u32")),
                f"run ({name}) frames == the unsharded run's")
        model = on_timeline(batches, "model_input")
        require(torch.equal(model.view(torch.int16),
                            on_timeline(plain, "model_input")
                            .view(torch.int16)),
                f"run ({name}) model tensors == the unsharded run's")
        for b in range(Bq):
            want_fr = src[b].to(DEV)
            require(torch.equal(fr[b] & 0xFFFFFF, want_fr & 0xFFFFFF)
                    if "lane" in name else torch.equal(fr[b], want_fr),
                    f"run ({name}) stream {b} frames == source frames")
            check_model(model[b], models[b], f"run ({name}) stream {b}")
        log(f"run ({name}): frames and model tensors bit-exact, equal to "
            f"the unsharded run's")
        res[name] = launches
        del plain, batches, fr, model
    return res


def phase_mesh_msv1(card: str, avis, unsharded) -> dict:
    """Run (r): run (m)'s B=8 CIF streams on a dp=4 mesh of cuda:0 slots;
    every window equals run (m)'s (frames, model tensors, significance),
    one msv1_paint launch a window a slot → its launches."""
    (batches, _, dt), launches = count_launches(
        lambda: run_ingest(avis, still_elision=False, mesh=card_mesh(4, 1)))
    log_mesh_run(card, "r", "MSV1 16-bit CIF on a dp=4 mesh", len(batches),
                 MSV1_B * T, dt, "m", launches)
    log(f"run (r) msv1_paint instances {launches['msv1_instances']}")
    require_launches(launches, {"msv1_paint": 4 * len(batches),
                                "ds2_pack": len(batches)}, "run (r)")
    require(len(batches) == len(unsharded), "run (r) windows == run (m)'s")
    for w, u in zip(batches, unsharded):
        require(w["start_frame"] == u["start_frame"]
                and torch.equal(w["frames_u32"], u["frames_u32"])
                and torch.equal(w["significant"], u["significant"])
                and torch.equal(w["model_input"].view(torch.int16),
                                u["model_input"].view(torch.int16)),
                f"run (r) window @{w['start_frame']} == run (m)'s")
    log("run (r): every window bit-exact, equal to run (m)'s")
    return launches


def phase_nccl(mesh_sig: torch.Tensor) -> None:
    """(s): a one-process NCCL group (init_multihost over localhost), the
    mesh's psum of run (o)'s significant-frame count through all_reduce,
    then the group destroyed."""
    import socket

    from jsplayer_tpu_torch.pipeline.mesh import init_multihost

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    init_multihost(f"127.0.0.1:{port}", 1, 0, backend="nccl")
    try:
        total = card_mesh(2, 1).psum([mesh_sig])
        torch.cuda.synchronize()
        require(torch.distributed.get_backend() == "nccl"
                and total.device.type == "cuda"
                and int(total) == int(mesh_sig),
                f"(s) NCCL psum {int(total)} == {int(mesh_sig)}")
    finally:
        torch.distributed.destroy_process_group()
    log(f"(s) one-process NCCL: psum of run (o)'s significant frames = "
        f"{int(total)}; process group destroyed (no traffic between cards "
        f"measured: one card)")


def phase_dryrun(card: str) -> dict:
    """jsplayer_tpu_torch.dryrun_multichip(4, "cuda"): every leg on four
    slots of the card → its launches."""
    from jsplayer_tpu_torch.dryrun import dryrun_multichip

    t0 = time.perf_counter()
    _, launches = count_launches(lambda: dryrun_multichip(4, "cuda"))
    log(f"dryrun_multichip(4, 'cuda'): every leg bit-exact in "
        f"{time.perf_counter() - t0:.3f} s; launches "
        + ", ".join(f"{k} {launches[k]}" for k in MESH_KERNELS
                    + ("sp_compose_general",)) + f" ({card})")
    for k in ("kmv_compose", "bc_compose", "lane_compose",
              "sp_compose_general", "rans_decode_aligned"):
        require(launches[k] > 0, f"the dry run launched {k} ({launches})")
    return launches


# ---------------------------------------------------------------------------
# The kmv_sparse transport: kmv_sparse_compose, runs (k) and (l)

def phase_sparse_kernel(card: str) -> dict:
    """kmv_sparse_compose against its twin on a random B=4 1080p step
    (experiments/sparse_step.step_inputs: tiles at the host's clamped
    starts, the bottom row overlapping the row above, indices that wrap or
    fall outside the rows, wrapping vectors and -2^31, codes past 2+K,
    stream 2 unchanged), bit for bit."""
    from jsplayer_tpu_torch.experiments.sparse_step import (sparse_bytes,
                                                            step_inputs)
    from jsplayer_tpu_torch.kernels.sp_recon import (kmv_sparse_compose,
                                                     kmv_sparse_compose_ref)

    prev, args, chg = step_inputs(DEV)
    got = kmv_sparse_compose(prev, *args, chg)
    want = kmv_sparse_compose_ref(prev, *args, chg)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    require(torch.equal(got, want), "kmv_sparse_compose bit-exact vs plain")
    out = torch.empty_like(prev)

    def step():
        kmv_sparse_compose(prev, *args, chg, out=out)

    return dict(max_abs_err=err, **step_report(
        "kmv_sparse_compose", f"[{B},{Y},{X}] K=2 random step, M="
        f"{args[3].shape[1]}, S={args[2].shape[0]}, bit-exact", card,
        time_ms(step), graph_ms(step),
        time_ms(lambda: kmv_sparse_compose_ref(prev, *args, chg), iters=2,
                warmup=1), sparse_bytes(prev, args, chg)))


def phase_sparse_step(card: str, chunks, src) -> dict:
    """kmv_sparse_compose on the P-frame step with the most tiles of the
    port's native sparse emission of the streams (the tiles run (k)
    ships), against its twin and the source frames."""
    from jsplayer_tpu_torch.experiments.sparse_step import (captured_step,
                                                            sparse_bytes)
    from jsplayer_tpu_torch.kernels.sp_recon import (kmv_sparse_compose,
                                                     kmv_sparse_compose_ref)

    t0 = time.perf_counter()
    t, prev, args, chg, want_frames = captured_step(chunks, src, DEV)
    log(f"native sparse emission of {B} x {T} frames, frame by frame in "
        f"{B} threads: {time.perf_counter() - t0:.3f} s")
    got = kmv_sparse_compose(prev, *args, chg)
    want = kmv_sparse_compose_ref(prev, *args, chg)
    torch.cuda.synchronize()
    require(torch.equal(got, want), "kmv_sparse_compose captured step "
            "bit-exact vs plain")
    require(torch.equal(got, want_frames), "kmv_sparse_compose captured "
            "step composes the source frames")
    out = torch.empty_like(prev)

    def step():
        kmv_sparse_compose(prev, *args, chg, out=out)

    return dict(step=t, **step_report(
        "kmv_sparse_compose", f"[{B},{Y},{X}] captured step {t} (M="
        f"{args[3].shape[1]}, S={args[2].shape[0]}), bit-exact", card,
        time_ms(step), graph_ms(step),
        time_ms(lambda: kmv_sparse_compose_ref(prev, *args, chg), iters=2,
                warmup=1), sparse_bytes(prev, args, chg)))


def check_dense(batches, src, models, what: str) -> None:
    """Dense windows (the last one padded past the streams' end with their
    last frame): every frame equal to its source frame, every model tensor
    to the plain epilogue, the windows tiling the streams."""
    n_real = 0
    for w in batches:
        t0, n = w["start_frame"], w["frames_u32"].shape[1]
        real = min(n, T - t0)
        for b in range(len(src)):
            fr = w["frames_u32"][b]
            require(torch.equal(fr[:real], src[b][t0:t0 + real].to(DEV)),
                    f"{what} stream {b} window @{t0} frames == source "
                    f"frames")
            require(bool((fr[real:] == fr[real - 1]).all()),
                    f"{what} stream {b} window @{t0} pads with its last "
                    f"frame")
            check_model(w["model_input"][b][:real],
                        models[b][t0:t0 + real],
                        f"{what} stream {b} window @{t0}")
        n_real += real
    require(n_real == T, f"{what} covers {T} frames")


def phase_sparse_runs(card: str, avis, src, models) -> dict:
    """Runs (k) and (l): sp_device_path "kmv_sparse" on the native branch,
    windows snapped to the shared keyframes (still_elision=True: the
    keyframes lead windows [0, 40) and [40, 104), so they ship as the
    scans' dense init), frames and ds2 model tensors; (l) with the tiles
    rANS-coded on the host and decoded by rans_decode_packed →
    {kernel: launches over both runs}."""
    total = {}
    for name, lane in (("k", False), ("l", True)):
        (batches, _, dt), launches = count_launches(
            lambda: run_ingest(avis, sp_device_path="kmv_sparse",
                               sparse_lane_payload=lane))
        log(f"run ({name}) kmv_sparse{' lane payload' if lane else ''}: "
            f"{len(batches)} windows @{[w['start_frame'] for w in batches]}"
            f", {B * T} frames in {dt:.3f} s = {B * T / dt:.1f} delivered "
            f"frames/s ({card}); launches {launches}")
        require_only(launches, ("kmv_sparse_compose", "ds2_pack")
                     + (("rans_decode_packed",) if lane else ()),
                     f"run ({name})")
        check_dense(batches, src, models, f"run ({name})")
        log(f"run ({name}): every stream's frames and model tensors "
            f"bit-exact")
        for k, v in launches.items():
            if not isinstance(v, dict):
                total[k] = total.get(k, 0) + v
        total[f"run_{name}"] = launches
        del batches
    return total


# ---------------------------------------------------------------------------
# MSVideo1: msv1_paint, runs (m) and (n)

def phase_msv1_kernel(card: str) -> dict:
    """msv1_paint against its twin on a random B=8 CIF window of 64 steps
    (experiments/msv1_step.window_inputs: a tenth of the blocks painted,
    sel 0-8), frames and diff flags bit for bit."""
    from jsplayer_tpu_torch.experiments.msv1_step import (msv1_bytes,
                                                          msv1_sector_bytes,
                                                          window_inputs)
    from jsplayer_tpu_torch.kernels.msv1_paint import (msv1_paint,
                                                       msv1_paint_ref)

    init, bt, sel, col = window_inputs(DEV)
    frames, diff = msv1_paint(init, bt, sel, col, 0)
    want_f, want_d = msv1_paint_ref(init, bt, sel, col, 0)
    torch.cuda.synchronize()
    err = max_abs_err(frames, want_f)
    require(torch.equal(frames, want_f) and torch.equal(diff, want_d),
            "msv1_paint bit-exact vs plain (frames and diff)")
    require(msv1_paint.last_instance == "staged",
            "msv1_paint ran its staged instance on the CIF window")
    out = torch.empty_like(frames)

    def call():
        msv1_paint(init, bt, sel, col, 0, out=out)

    Bm, Tm = bt.shape[:2]
    res = dict(max_abs_err=err, steps=Tm, instance=msv1_paint.last_instance,
               sector_bytes=msv1_sector_bytes(init, bt, frames),
               **step_report(
        "msv1_paint", f"{list(frames.shape)} random window (one launch), "
        f"bit-exact", card, time_ms(call), graph_ms(call),
        time_ms(lambda: msv1_paint_ref(init, bt, sel, col, 0), iters=2,
                warmup=1), msv1_bytes(init, bt, frames)))
    log(f"msv1_paint: {res['graph_ms'] / Tm * 1e3:.2f} us a step of {Bm} "
        f"CIF frames as a CUDA graph ({card})")
    return res


def msv1_twin_window(s, w, bits, X_, Y_, prev) -> tuple:
    """The twin's (frames, significance) of one MSV1 window of run (m) or
    (n): the window's frames parsed again by the native parser, then
    msv1_paint_ref and signif_from on the card from `prev` (the window's
    carry-in: the source frames before it, zeros for the first)."""
    from jsplayer_tpu_torch import native
    from jsplayer_tpu_torch.codecs.msvideo1 import palette_to_u32
    from jsplayer_tpu_torch.kernels import msv1_paint as M

    t0, n = w["start_frame"], w["frames_u32"].shape[1]
    pal = palette_to_u32(s["palettes"][0]) if bits == 8 else None
    parsed = [[native.native_msv1_parse(c, X_, Y_, pal=pal)
               for c in (ch[t0:t0 + n] + [b""] * n)[:n]]
              for ch in s["chunks"]]
    bt, sel, col, chg = (np.stack([np.stack([p[i] for p in ps])
                                   for ps in parsed]) for i in range(4))
    dev = [torch.from_numpy(np.ascontiguousarray(
        a.view(np.int32) if a.dtype == np.uint32 else a)).to(DEV)
        for a in (bt, M.sel_to_plane(sel, Y_, X_), col, chg)]
    frames, diff = M.msv1_paint_ref(prev, *dev[:3], 0)
    valid = torch.full((len(s["chunks"]),), t0 > 0, device=DEV)
    return frames, M.signif_from(dev[0], dev[3], valid, diff, 0, X_ // 4)


def phase_msv1_runs(card: str) -> dict:
    """Runs (m) MSV1 16-bit CIF (352x288) and (n) MSV1 8-bit palettized
    320x240 with MP3 tracks (BASELINE configs 1-2), B=8 x 128 frames made
    by the port's msv1_enc (experiments/msv1_step.msv1_streams), frames and
    ds2 model tensors: each pool stream's frames checked by the port's host
    oracle (codecs/msvideo1) against their source, then every ingested
    frame against its source frame, every model tensor against the plain
    CPU epilogue, and the significance against the twin's → {kernel:
    launches over both runs}."""
    from jsplayer_tpu_torch.codecs.msvideo1 import (MSVideo1_8bit,
                                                    MSVideo1_16bit)
    from jsplayer_tpu_torch.core.source import MemorySource
    from jsplayer_tpu_torch.experiments.msv1_step import msv1_streams
    from jsplayer_tpu_torch.kernels.rgb_convert import to_model_input
    from jsplayer_tpu_torch.pipeline.ingest import StreamReader

    Bm, total = MSV1_B, {}
    for name, bits, X_, Y_ in MSV1_RUNS:
        t0 = time.perf_counter()
        s = msv1_streams(bits, Bm, T, X_, Y_)
        P_ = s["period"]
        log(f"run ({name}) streams: {Bm} x {T} MSV1 {bits}-bit {X_}x{Y_} "
            f"frames ({s['pool']} distinct streams of {P_}-frame periods led "
            f"by a keyframe) encoded in {time.perf_counter() - t0:.3f} s")
        for b in range(s["pool"]):
            dec = (MSVideo1_16bit(X_, Y_) if bits == 16
                   else MSVideo1_8bit(X_, Y_, s["palettes"][b]))
            dec.preinit(0)
            for t, c in enumerate(s["chunks"][b][:P_]):
                dst = np.zeros(X_ * Y_, dtype=np.uint32)
                if dec.is_key_frame(c):
                    dec.decompress_i(c, dst)
                else:
                    dec.decompress_p(c, dst)
                require(np.array_equal(dec.previous_frame(),
                                       s["frames"][b][t]),
                        f"run ({name}) stream {b} frame {t}: the host "
                        f"oracle decodes the source frame")
        if bits == 8:
            tracks = [StreamReader(MemorySource(a)).audio_track
                      for a in s["avis"]]
            require(all(tr is not None and tr.sections for tr in tracks),
                    f"run ({name}) every stream's MP3 track parses")
        srcs = [torch.from_numpy(np.stack([s["frames"][b][t % P_]
                                           for t in range(T)])
                                 .view(np.int32).reshape(T, Y_, X_))
                for b in range(Bm)]
        models = [to_model_input(f, downscale=2).view(torch.int16).to(DEV)
                  for f in srcs]
        (batches, _, dt), launches = count_launches(
            lambda: run_ingest(s["avis"], still_elision=False))
        log(f"run ({name}) MSV1 {bits}-bit {X_}x{Y_}: {len(batches)} windows"
            f", {Bm * T} frames in {dt:.3f} s = {Bm * T / dt:.1f} delivered "
            f"frames/s ({card}); launches {launches}")
        require_only(launches, ("msv1_paint", "ds2_pack"), f"run ({name})")
        require(launches["msv1_paint"] == len(batches),
                f"run ({name}) one msv1_paint launch a window")
        require(launches["msv1_instances"] == {"staged": len(batches)},
                f"run ({name}) msv1_paint ran its staged instance "
                f"({launches['msv1_instances']})")
        check_dense(batches, srcs, models, f"run ({name})")
        if name == "m":
            FPS["m"] = Bm * T / dt
            total["run_r"] = phase_mesh_msv1(card, s["avis"], batches)
        prev = torch.zeros((Bm, Y_, X_), dtype=torch.int32, device=DEV)
        for w in batches:
            frames, sig = msv1_twin_window(s, w, bits, X_, Y_, prev)
            require(torch.equal(frames, w["frames_u32"])
                    and torch.equal(sig, w["significant"]),
                    f"run ({name}) window @{w['start_frame']} frames and "
                    f"significance == the plain twin's")
            prev = w["frames_u32"][:, -1]
        log(f"run ({name}): every stream's frames, model tensors and "
            f"significance bit-exact")
        for k, v in launches.items():
            if not isinstance(v, dict):
                total[k] = total.get(k, 0) + v
        total[f"run_{name}"] = launches
        del batches, srcs, models
    return total


def phase_rans_kernels(card: str) -> tuple[dict, dict]:
    """Both rANS decodes against their twins at N=4096 lanes, B=4, on the
    dense 1080p window (experiments/lane_step.dense_rans: encoded once by
    the port's build_freq_table, encode_lanes and layout_refills, repeated
    over the 4 streams; every stream must decode to the source symbols) and
    on random u32 states, refills and lane bytes; then roundtrip_decode,
    rans_decode_packed's route (no ingest path runs it), on the dense
    window → ({kernel: numbers}, launches in the round trip)."""
    from jsplayer_tpu_torch.experiments import lane_step as LS
    from jsplayer_tpu_torch.kernels import rans_lanes as R

    t0 = time.perf_counter()
    d = LS.dense_rans()
    log(f"dense window: {d['n']} symbols, {d['steps']} steps of "
        f"{LS.N_LANES} lanes, encoded in {time.perf_counter() - t0:.3f} s "
        f"(host, once)")
    inputs = {"dense": LS.rans_batch(d, DEV), "random": LS.random_rans(DEV)}
    syms = torch.from_numpy(d["syms"]).to(DEV)
    chains = {}
    for what, a in inputs.items():
        chains[what] = LS.chain_bound(a)
        require(chains[what]["exact"], f"the chain probe on the {what} "
                f"inputs bit-exact vs plain")
        log(f"chain bound [{B},{a['steps']},{LS.N_LANES}] {what}: "
            f"{chains[what]['graph_ms']:.4f} ms as a CUDA graph, "
            f"{chains[what]['ms']:.4f} by events ({card})")
    res = {}
    for name, packed in (("rans_decode_aligned", False),
                         ("rans_decode_packed", True)):
        for what, a in inputs.items():
            kernel, twin = LS.rans_call(a, packed)
            got, want = kernel(), twin()
            torch.cuda.synchronize()
            err = max_abs_err(got, want)
            require(torch.equal(got, want), f"{name} {what} bit-exact vs "
                    f"plain")
            if not packed:
                require(R.rans_decode_aligned.last_instance == "staged",
                        f"{name} {what} ran its staged instance")
            if what == "dense":
                require(all(torch.equal(got[b].reshape(-1)[: d["n"]], syms)
                            for b in range(B)),
                        f"{name} decodes the dense window's symbols")
            ms, graph = time_ms(kernel), graph_ms(kernel)
            r = dict(max_abs_err=err, msym_s=LS.msym_s(a, ms),
                     graph_msym_s=LS.msym_s(a, graph), **step_report(
                         name, f"[{B},{a['steps']},{LS.N_LANES}] {what}, "
                         f"bit-exact", card, ms, graph,
                         time_ms(twin, iters=2, warmup=1),
                         LS.rans_bytes(a, packed)))
            chain = chains[what]["graph_ms"]
            r.update(instance=("ring" if packed
                               else R.rans_decode_aligned.last_instance),
                     chain_bound_ms=chain, chain_share=chain / graph,
                     bytes_share=r["bound_ms"] / graph,
                     share=max(chain, r["bound_ms"]) / graph)
            log(f"{name} {what}: {r['msym_s']:.0f} Msym/s through the "
                f"wrapper, {r['graph_msym_s']:.0f} as a CUDA graph; chain "
                f"bound {chain:.4f} ms, {100 * r['chain_share']:.1f}% of it "
                f"(graph), {r['instance']} instance")
            if what == "dense":
                res[name] = r
            else:
                res[name]["random"] = r
    clocks = sm_clocks(LS.rans_call(inputs["dense"], False)[0])
    log(f"SM clocks (clocks.sm, clocks.max.sm) under rans_decode_aligned: "
        f"{clocks} ({card})")
    res["rans_decode_aligned"]["sm_clocks"] = clocks
    del inputs
    rt, launches = count_launches(lambda: R.roundtrip_decode(
        d["lane_bytes"], d["states"], d["freq"], d["n"], LS.N_LANES,
        device=str(DEV)))
    require(np.array_equal(rt, d["syms"]), "roundtrip_decode on the card "
            "recovers the dense window's symbols")
    require_only(launches, ("rans_decode_packed",), "roundtrip_decode")
    return res, launches


def phase_validate(card: str) -> dict:
    """jsplayer_tpu_torch.validate's nine parity legs on the card, each
    true, each through its kernel."""
    from jsplayer_tpu_torch import validate

    t0 = time.perf_counter()
    res, launches = count_launches(lambda: validate.run(str(DEV)))
    log(f"validate legs: {json.dumps(res)} in {time.perf_counter() - t0:.3f}"
        f" s ({card}); launches {launches}")
    require(set(res) == set(validate.LEGS) and all(res.values()),
            f"every validate leg true ({res})")
    for k in ("sp_compose_general", "sp_motion_patch", "sp_motion_mxu",
              "kmv_compose", "kmv_sparse_compose", "bc_compose",
              "lane_compose", "rans_decode_aligned"):
        require(launches[k] > 0, f"the validate legs launched {k}")
    require_staged(launches, "the validate legs")
    return res


# ---------------------------------------------------------------------------
# Phase (e): the ds2 experiments

#: the ds_probe modes, each at its script's full stack depth
PROBE_DEPTH = {"ds2_fields": 64, "bitcast_fold": 64, "passthru": 64,
               "pack_h": 64, "sum4": 64, "hpair_i32": 4, "hpair_lowbyte": 4,
               "wpair_i32": 4, "block_transpose": 4}
#: the ds_probe modes with a 16-byte and a 4-byte instance (rows_kernel)
ROW_MODES = ("passthru", "hpair_i32", "wpair_i32")


def rand_dev(shape, seed):
    return rand_frames(shape, DEV, seed)


def phase_experiment_kernels(card: str) -> dict:
    """kmv_compose_ds2 on random B=4 inputs (wrapping vectors, an unchanged
    stream) and an odd shape; every ds_probe mode at its script's shape
    (BH=128, a partial last block); each bit-exact against its twin."""
    from jsplayer_tpu_torch.experiments.kmv_step import ds2_inputs
    from jsplayer_tpu_torch.experiments.probe_step import CALLS, torch_passthru
    from jsplayer_tpu_torch.experiments.probes import (padded,
                                                       probe_read_words,
                                                       probe_ref)
    from jsplayer_tpu_torch.kernels.ds_probe import ds_probe
    from jsplayer_tpu_torch.kernels.rgb_convert import ds2_pack
    from jsplayer_tpu_torch.kernels.sp_recon import (kmv_compose,
                                                     kmv_compose_ds2,
                                                     kmv_compose_ds2_ref)

    res, errs = {}, []
    for seed, (Bk, Yk, Xk) in enumerate(((4, Y, X), (3, Y + 1, X + 3))):
        prev, pc, mvk, chg = ds2_inputs((Bk, Yk, Xk), seed, DEV)
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
        def step():
            kmv_compose_ds2(prev, pc, mvk, chg, out=out, red=red)

        res["kmv_compose_ds2"] = step_report(
            "kmv_compose_ds2", f"[{Bk},{Yk},{Xk}] K=2 random step, "
            f"bit-exact", card, time_ms(step), graph_ms(step),
            time_ms(lambda: kmv_compose_ds2_ref(prev, pc, mvk, chg)),
            kmv_bytes(pc, mvk, chg, red))
        unfused_ms = time_ms(lambda: ds2_pack(
            kmv_compose(prev, pc, mvk, chg, out=out), flip=False))
        log(f"kmv_compose + ds2_pack on the same step: {unfused_ms:.4f} "
            f"ms/call through the wrappers ({card})")
        res["kmv_compose_ds2"]["unfused_ms"] = unfused_ms
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
        if mode in ROW_MODES:
            require(ds_probe.last_instance == "vec",
                    f"{mode} [{depth},{Y},{X}] ran its 16-byte instance "
                    f"({ds_probe.last_instance})")
        if mode == "passthru":
            require(torch.equal(got, torch_passthru(padded(f, 128))),
                    f"passthru [{depth},{Y},{X}] bit-exact vs torch's slice "
                    f"copy of the zero-padded frames")
        out = torch.empty_like(got)

        def call():
            ds_probe(f, mode, out=out)

        nbytes = 4 * probe_read_words(mode, *f.shape) + io_bytes(got)
        modes[mode] = dict(shape=list(got.shape), max_abs_err=err,
                           **step_report(
                               f"ds_probe {mode}", f"[{depth},{Y},{X}] -> "
                               f"{list(got.shape)}, bit-exact", card,
                               time_ms(call), graph_ms(call),
                               time_ms(lambda: probe_ref(f, mode)), nbytes))
        del got, want, out
    for mode in CALLS:
        modes[mode].update(phase_library_yardstick(card, mode))
    pack_ms = time_ms(lambda: ds2_pack(frames[64]))
    log(f"ds2_pack [64,{Y},{X}] beside ds2_fields: {pack_ms:.4f} ms/call "
        f"({card})")
    fields = modes["ds2_fields"]
    res["ds_probe"] = dict(max_abs_err=max(m["max_abs_err"]
                                           for m in modes.values()),
                           modes=modes, **{k: fields[k] for k in (
                               "ms", "graph_ms", "plain_ms", "bytes",
                               "bound_ms", "bound_by", "library_ms")})
    return res


def phase_library_yardstick(card: str, mode: str) -> dict:
    """ds_probe `mode` beside the one PyTorch call that computes the same
    function (experiments/probe_step.CALLS: torch's transpose copy, its
    strided-slice copy, its add of two strided views) at the script's depth
    and 1024 rows (Y a multiple of BH, as the call needs), both bit-exact
    against the twin → {"library_ms", "library_graph_ms", "library_shape",
    "y1024": the kernel's numbers there}; the pair modes add each one's
    time with a cold L2 ("library_cold_ms", y1024's "cold_ms":
    experiments/common.cold_ms)."""
    from jsplayer_tpu_torch.experiments.common import cold_ms
    from jsplayer_tpu_torch.experiments.probe_step import CALLS, PAIR_MODES
    from jsplayer_tpu_torch.experiments.probes import (probe_read_words,
                                                       probe_ref)
    from jsplayer_tpu_torch.kernels.ds_probe import ds_probe

    library = CALLS[mode][1]
    shape = (PROBE_DEPTH[mode], 1024, X)
    f = rand_dev(shape, 1024 + PROBE_DEPTH[mode])
    want = probe_ref(f, mode)
    got = ds_probe(f, mode)
    lib = library(f)
    torch.cuda.synchronize()
    require(torch.equal(got, want) and torch.equal(lib, want),
            f"{mode} and {library.__name__} bit-exact on {list(shape)}")
    if mode in ROW_MODES:
        require(ds_probe.last_instance == "vec",
                f"{mode} {list(shape)} ran its 16-byte instance "
                f"({ds_probe.last_instance})")
    out = torch.empty_like(want)

    def call():
        ds_probe(f, mode, out=out)

    lib_ms = time_ms(lambda: library(f))
    lib_graph = graph_ms(lambda: library(f))
    res = step_report(f"ds_probe {mode}", f"{list(shape)}, bit-exact",
                      card, time_ms(call), graph_ms(call),
                      time_ms(lambda: probe_ref(f, mode)),
                      4 * probe_read_words(mode, *shape) + io_bytes(want))
    log(f"{library.__name__} {list(shape)}: {lib_ms:.4f} ms/call, "
        f"{lib_graph:.4f} as a CUDA graph, "
        f"{100 * res['bound_ms'] / lib_graph:.1f}% of bound (graph); "
        f"ds_probe {mode} {res['graph_ms']:.4f} "
        f"({100 * res['bound_ms'] / res['graph_ms']:.1f}%) ({card})")
    out_res = dict(library_ms=lib_ms, library_graph_ms=lib_graph,
                   library_shape=list(shape), y1024=res)
    if mode in PAIR_MODES:
        res["cold_ms"] = cold_ms(call)
        out_res["library_cold_ms"] = cold_ms(lambda: library(f))
        log(f"{mode} {list(shape)} with a cold L2: ds_probe "
            f"{res['cold_ms']:.4f} ms "
            f"({100 * res['bound_ms'] / res['cold_ms']:.1f}% of bound), "
            f"{library.__name__} {out_res['library_cold_ms']:.4f} ms "
            f"({100 * res['bound_ms'] / out_res['library_cold_ms']:.1f}%) "
            f"({card})")
    del f, want, got, lib, out
    return out_res


def load_bench_mix():
    """The 1080p bench-mix stream's compacted kmv transport on the card →
    (init, paycode [T', Y, X], mvk [T', K, 2], T')."""
    from jsplayer_tpu_torch.experiments import exp_model_fusion2 as F

    t0 = time.perf_counter()
    stream = F.load_stream(DEV)
    log(f"bench-mix stream {F.X}x{F.Y}, {F.T} frames ({stream[3]} "
        f"changed), encoded and decoded in {time.perf_counter() - t0:.3f} s")
    return stream


def phase_kmv_bench_mix(card: str, stream) -> dict:
    """Both kmv kernels on the B=1 1080p steps the CONCAT main path
    launches: the bench-mix stream's compacted steps scanned from a zero
    frame (prev is the step before's out), kmv_compose through
    decode_sequence_kmv_compact, the scan the CONCAT path runs, and
    kmv_compose_ds2 (which no ingest scan runs) through the same loop by
    hand; every step bit-exact against the plain twins → {kernel: numbers
    per step}.  Beside the bound on the function's bytes, dram_bound_ms
    counts only paycode, out and red: prev, the step before's out, is warm
    in the 50 MB L2."""
    from jsplayer_tpu_torch.kernels.rgb_convert import ds2_pack_ref
    from jsplayer_tpu_torch.kernels.sp_recon import (
        decode_sequence_kmv_compact, kmv_compose_ds2, kmv_compose_ref)

    init, pc, mvk, steps = stream
    chg = torch.ones(1, dtype=torch.bool, device=DEV)
    frames = torch.empty((steps, Y, X), dtype=torch.int32, device=DEV)
    reds = torch.empty((steps, Y // 2, X // 2), dtype=torch.int32,
                       device=DEV)

    def compact():
        return decode_sequence_kmv_compact(init, pc, mvk)

    def fused_scan():
        prev = init[None]
        for t in range(steps):
            out = frames[t:t + 1]
            kmv_compose_ds2(prev, pc[t:t + 1], mvk[t:t + 1], chg, out=out,
                            red=reds[t:t + 1])
            prev = out
        return frames, reds

    def plain_scan(fused):
        prev, outs = init[None], []
        for t in range(steps):
            prev = kmv_compose_ref(prev, pc[t:t + 1], mvk[t:t + 1], chg)
            outs.append(prev)
        out = torch.cat(outs)
        return (out, ds2_pack_ref(out, flip=False)) if fused else out

    res = {}
    chgs = torch.ones(steps, dtype=torch.bool, device=DEV)
    for name, scan, fused in (("kmv_compose", compact, False),
                              ("kmv_compose_ds2", fused_scan, True)):
        frames.fill_(0x7EADBEEF)
        got = scan()
        want = plain_scan(fused)
        torch.cuda.synchronize()
        require(all(torch.equal(g, w) for g, w in zip(got, want))
                if fused else torch.equal(got, want),
                f"{name} bench-mix scan of {steps} steps bit-exact vs plain")
        red = reds if fused else None
        dram = bound(io_bytes(pc, frames, mvk, chgs)
                     + (io_bytes(red) if fused else 0))["bound_ms"] / steps
        res[name] = dict(steps=steps, **step_report(
            name, f"[1,{Y},{X}] bench-mix scan, {steps} steps, bit-exact",
            card, time_ms(scan, iters=5) / steps,
            graph_ms(scan, iters=1, replays=10) / steps,
            time_ms(lambda: plain_scan(fused), iters=2, warmup=1) / steps,
            kmv_bytes(pc, mvk, chgs, red) // steps, dram_bound_ms=dram))
        log(f"{name} bench-mix: DRAM-only bound {dram:.4f} ms/step, "
            f"{100 * dram / res[name]['graph_ms']:.1f}% (graph)")
    return res


def phase_experiments(card: str, stream) -> dict:
    """The experiments' entry points: exp_model_fusion2's seven variants on
    the 1080p bench-mix stream (T=64, compacted), each equal to variant A;
    exp_pallas_ds's six variants, exp_pallas_ds2's and exp_pallas_bisect's
    probes at their scripts' shapes, each equal to its twin."""
    from jsplayer_tpu_torch.experiments import (exp_model_fusion2 as F,
                                                exp_pallas_bisect,
                                                exp_pallas_ds,
                                                exp_pallas_ds2)
    from jsplayer_tpu_torch.experiments.common import require_parity

    init, pc, mvk, _ = stream
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
    inst = launches["ds_probe_instances"]
    require(inst == {m: {"vec": launches["ds_probe_modes"][m]}
                     for m in ROW_MODES},
            f"phase (e) ran the row modes' 16-byte instances ({inst})")
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
    kernels["bc_compose"] = phase_bc_kernel(card)

    t0 = time.perf_counter()
    avis, frames, chunks = screen_streams()
    src = [torch.from_numpy(f.view(np.int32)) for f in frames]
    log(f"made {B} streams x {T} frames {X}x{Y} "
        f"({sum(len(a) for a in avis)} AVI bytes) in "
        f"{time.perf_counter() - t0:.3f} s")
    cap = capture(chunks)
    kernels.update(phase_block_kernels(card, cap, src))
    launches = {}
    mxu = phase_mxu_scan(card, cap, src)
    launches["sp_motion_mxu"] = mxu["sp_motion_mxu"]
    for name, r in phase_block_scan(card, cap, src).items():
        kernels[name]["b1_scan"] = r
    del cap
    models = model_reference(src)

    kmv = phase_kmv_runs(card, avis, src, models)
    launches.update(kmv_compose=kmv["kmv_compose"], ds2_pack=kmv["ds2_pack"])
    for name, path, kernel in (("c", "pallas", "sp_motion_patch"),
                               ("d", "general", "sp_compose_general")):
        got = phase_block_run(card, name, path, kernel, avis, src, models)
        launches[kernel] = got[kernel]
    bc = bc_capture(chunks)
    kernels["bc_compose"]["captured"] = phase_bc_step(card, bc, src)
    kernels["bc_compose"]["b1_scan"] = phase_bc_scan(card, bc, src)
    del bc
    launches["bc_compose"] = phase_bc_runs(card, avis, src,
                                           models)["bc_compose"]
    conts = lane_containers(avis)
    kernels["lane_compose"] = phase_lane_kernel(card)
    windows = lane_windows(conts["raw"])
    kernels["lane_compose"]["captured"] = phase_lane_step(card, windows, src)
    kernels["lane_compose"]["b1_scan"] = phase_lane_scan(card, windows, src)
    del windows
    lane = phase_lane_runs(card, conts, src, models)
    launches.update(lane_compose=lane["lane_compose"],
                    rans_decode_aligned=lane["rans_decode_aligned"])
    del conts
    kernels["kmv_sparse_compose"] = phase_sparse_kernel(card)
    kernels["kmv_sparse_compose"]["captured"] = phase_sparse_step(
        card, chunks, src)
    sparse = phase_sparse_runs(card, avis, src, models)
    launches["kmv_sparse_compose"] = sparse["kmv_sparse_compose"]
    mesh_runs, mesh_sig = phase_mesh_dp(card, avis, src, models)
    mesh_runs.update(phase_mesh_gop(card, frames, src, models))
    phase_nccl(mesh_sig)
    del avis, frames, chunks, src, models
    kernels["msv1_paint"] = phase_msv1_kernel(card)
    msv1 = phase_msv1_runs(card)
    launches["msv1_paint"] = msv1["msv1_paint"]
    mesh_runs["r"] = msv1["run_r"]
    mesh_runs["dryrun"] = phase_dryrun(card)
    phase_validate(card)
    rans, rt = phase_rans_kernels(card)
    kernels.update(rans)
    # the packed decode's ingest route is run (l); roundtrip_decode its other
    launches["rans_decode_packed"] = sparse["rans_decode_packed"]
    kernels["rans_decode_packed"]["roundtrip_launches"] = \
        rt["rans_decode_packed"]

    kernels.update(phase_experiment_kernels(card))
    stream = load_bench_mix()
    exp = phase_experiments(card, stream)
    for name, r in phase_kmv_bench_mix(card, stream).items():
        kernels[name]["bench_mix"] = r
    del stream
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
                     "scripts/exp_pallas_bisect.py:19-65"),
        "bc_compose": ("jsplayer_tpu_torch/csrc/bc_compose.cu",
                       "jsplayer_tpu/kernels/sp_recon.py:323"),
        "lane_compose": ("jsplayer_tpu_torch/csrc/bc_compose.cu",
                         "jsplayer_tpu/kernels/lane_recon.py:70"),
        "rans_decode_aligned": ("jsplayer_tpu_torch/csrc/rans_lanes.cu",
                                "jsplayer_tpu/kernels/rans_lanes.py:195"),
        "rans_decode_packed": ("jsplayer_tpu_torch/csrc/rans_lanes.cu",
                               "jsplayer_tpu/kernels/rans_lanes.py:102"),
        "kmv_sparse_compose": ("jsplayer_tpu_torch/csrc/kmv_sparse.cu",
                               "jsplayer_tpu/kernels/sp_recon.py:738"),
        "msv1_paint": ("jsplayer_tpu_torch/csrc/msv1_paint.cu",
                       "jsplayer_tpu/kernels/msv1_paint.py:45,69")}
    ref = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jsplayer_tpu", "jax"))
    require(not ref, f"the run imported nothing of jax or jsplayer_tpu "
            f"({ref})")
    log(f"total {time.perf_counter() - t_all:.3f} s")
    for r in kernels.values():  # the share of the bound, by the graph time
        r.setdefault("share", r["bound_ms"] / r.get("graph_ms", r["ms"]))
    for name in MESH_KERNELS:  # each kernel's launches in the mesh runs
        kernels[name]["mesh_launches"] = {
            run: got[name] for run, got in mesh_runs.items() if got[name]}
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

"""A dry run of the sharded decode over an n-slot (dp, gop) mesh.

The port's counterpart of ``__graft_entry__.dryrun_multichip``, with the
same legs at the same 32x32 sizes, each checked against the source
frames or against another leg:

  * the sharded general and kmv steps (pipeline/batch.py) on
    keyframe-led GOPs, equal to each other (frames and model tensors);
  * the mesh's psum of the significance;
  * dp ingest with still-elision (the PADDED layout under a mesh);
  * gop-grouped kmv ingest (G keyframe-led windows a dispatch);
  * bc ingest on dp;
  * lane ingest on dp; lane gop grouping, raw and rANS; a ragged gop
    group (restart windows of unequal length in one dispatch).

    python -m jsplayer_tpu_torch.dryrun [n] [device]

Every slot is on `device` ("cuda" by default: one card holds all n slots;
"cpu" runs the plain versions).  Torch has no platform race, so unlike
the reference it runs in the calling process.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .core.source import MemorySource
from .device import torch_to_u32
from .encode.avi_mux import mux_avi
from .encode.sp_enc import ScreenPressorEncoder, pack_rgb
from .pipeline.ingest import IngestConfig, VideoIngestPipeline
from .pipeline.mesh import bg_slots, make_mesh

X = Y = 32


def _check(got: np.ndarray, want: np.ndarray, what: str) -> None:
    if not np.array_equal(got, want):
        raise RuntimeError(f"dryrun_multichip: {what} differs")


def _frames(batch) -> np.ndarray:
    return torch_to_u32(batch["frames_u32"])


def _keyframe_avis(rng, streams: int, n: int, keyframe, color):
    """SP v4 32x32 streams of n frames, a fresh encoder at each keyframe
    (keyframe(t) → bool), with changing rows and stills → (avis, golds)."""
    avis, golds = [], []
    for b in range(streams):
        enc = None
        ss, gg, kk = [], [], []
        f = np.full((Y, X), pack_rgb(*color(b)), dtype=np.uint32)
        for t in range(n):
            isk = keyframe(t)
            if not isk and t % 3 != 2:
                f = f.copy()
                f[(t % 5) * 4: (t % 5) * 4 + 4, 2:20] = pack_rgb(
                    *rng.integers(0, 256, 3))
            if isk:
                enc = ScreenPressorEncoder(4, X, Y)
                ss.append(enc.encode_i(f.reshape(-1).copy()))
            else:
                ss.append(enc.encode_p(f.reshape(-1).copy()))
            gg.append(f.reshape(-1).copy())
            kk.append(isk)
        avis.append(mux_avi(ss, X, Y, 24, codec="SPV4", keyflags=kk))
        golds.append(gg)
    return avis, golds


def _check_dense(pipe, golds, streams: int, mask: int = 0xFFFFFFFF) -> int:
    """Every emitted frame of streams [0, streams) against its gold →
    how many were checked."""
    seen = 0
    for batch in pipe:
        fr = _frames(batch)
        for b in range(streams):
            for t in range(fr.shape[1]):
                gi = batch["start_frame"] + t
                if gi < len(golds[b]):
                    _check(fr[b, t].reshape(-1) & mask, golds[b][gi] & mask,
                           f"stream {b} frame {gi}")
                    seen += 1
    return seen


def dryrun_multichip(n_devices: int, device: str = "cuda") -> None:
    """Sharded decode over an n-slot mesh of `device`: dp (streams) x gop
    (keyframe-led windows), with the mesh's psum.  Raises on any
    disagreement."""
    from . import native as _nat
    from .codecs import lane_format
    from .kernels import sp_recon
    from .pipeline.batch import (DecodeConfig, make_sp_decode_step,
                                 make_sp_decode_step_kmv, stack_sp_commands)
    from .transcode import transcode_to_lane

    gop = 2 if n_devices % 2 == 0 else 1
    dp = n_devices // gop
    mesh = make_mesh(dp=dp, gop=gop, devices=[device] * n_devices)

    B, G, Tg = dp, gop, 3
    rng = np.random.default_rng(0)
    streams = []
    for b in range(B):
        s_all = []
        for g in range(G):
            enc = ScreenPressorEncoder(4, X, Y)  # fresh per GOP: independent
            f = np.full((Y, X), pack_rgb(b, g, 7), dtype=np.uint32)
            f[4:9, 4:9] = pack_rgb(*rng.integers(0, 256, 3))
            f = f.reshape(-1)
            s_all.append(enc.encode_i(f))
            for t in range(Tg - 1):
                f = f.copy().reshape(Y, X)
                f[10 + t: 14 + t, 10:20] = pack_rgb(*rng.integers(0, 256, 3))
                f = f.reshape(-1)
                s_all.append(enc.encode_p(f))
        streams.append(s_all)

    cmds = stack_sp_commands(streams, X, Y, gops=G)
    cfg = DecodeConfig(height=Y, width=X, emit_model_input=True)
    out, signif = make_sp_decode_step(mesh, cfg)(
        cmds["bts"], cmds["mv"], cmds["rect"], cmds["payload"],
        cmds["changed"])
    if tuple(out.shape) != (B, G, Tg, Y, X, 3) or \
            tuple(signif.shape) != (B, G, Tg):
        raise RuntimeError(f"dryrun_multichip: shapes {tuple(out.shape)}, "
                           f"{tuple(signif.shape)}")
    # the production kmv transport over the same mesh
    pcs = np.zeros((B, G, Tg, Y, X), dtype=np.uint32)
    mvks = np.zeros((B, G, Tg, 2, 2), dtype=np.int32)
    for b in range(B):
        for g in range(G):
            pcs[b, g], mvks[b, g] = sp_recon.prepare_kmv(
                cmds["bts"][b, g], cmds["mv"][b, g], cmds["rect"][b, g],
                cmds["payload"][b, g], K=2)
    kout = make_sp_decode_step_kmv(mesh, cfg)(
        np.zeros((B, G, Y, X), np.uint32), pcs, mvks, cmds["changed"])
    if not torch.equal(kout.view(torch.int16), out.view(torch.int16)):
        raise RuntimeError("dryrun_multichip: the kmv step's model tensors "
                           "differ from the general step's")
    # the collective: the global significant-frame count
    total = mesh.psum([signif[rows, cols].to(torch.int64).sum()
                       for rows, cols in bg_slots(mesh, B, G).values()])
    if int(total) != int(signif.sum()):
        raise RuntimeError(f"dryrun_multichip: psum {int(total)} != "
                           f"{int(signif.sum())}")

    # dp ingest with still-elision (the PADDED layout under a mesh),
    # checked through the outmap timeline
    mesh_dp = make_mesh(dp=n_devices, gop=1, devices=[device] * n_devices)
    avis, golds = [], []
    for b in range(n_devices):
        enc = ScreenPressorEncoder(4, X, Y)
        f = np.full((Y, X), pack_rgb(b, 40, 80), dtype=np.uint32)
        ss, gg = [], []
        for t in range(6):
            if t not in (2, 4):  # stills → elision has real work to skip
                f = f.copy()
                f[(t % 4) * 6: (t % 4) * 6 + 5, 4:24] = pack_rgb(
                    *rng.integers(0, 256, 3))
            flat = f.reshape(-1)
            ss.append(enc.encode_i(flat) if t == 0 else enc.encode_p(flat))
            gg.append(flat.copy())
        avis.append(mux_avi(ss, X, Y, 24, codec="SPV4",
                            keyflags=[t == 0 for t in range(6)]))
        golds.append(gg)
    pipe = VideoIngestPipeline(
        [MemorySource(a) for a in avis],
        IngestConfig(window=3, still_elision=True, mesh=mesh_dp,
                     device=device))
    carry = [None] * n_devices
    for batch in pipe:
        fr = _frames(batch)
        outmap = np.asarray(batch["outmap"])
        for b in range(n_devices):
            rows = []
            for t in range(outmap.shape[1]):
                gi = batch["start_frame"] + t
                if gi >= len(golds[b]):
                    break
                if outmap[b, t] >= 0:
                    rows.append(int(outmap[b, t]))
                    got = fr[outmap[b, t]].reshape(-1)
                else:
                    got = carry[b]
                _check(got, golds[b][gi], f"elided stream {b} frame {gi}")
            if rows:
                carry[b] = fr[max(rows)].reshape(-1)

    # gop-grouped kmv ingest on the (dp, gop) mesh: G keyframe-led windows
    # a dispatch (needs the native host stage)
    Wg = 3
    if gop > 1:
        avis_g, golds_g = _keyframe_avis(
            rng, dp, Wg * 2 * gop, lambda t: t % Wg == 0,
            lambda b: (90, b, 21))
    if gop > 1 and _nat.available():
        seen = _check_dense(VideoIngestPipeline(
            [MemorySource(a) for a in avis_g],
            IngestConfig(window=Wg, mesh=mesh, emit_model_input=False,
                         device=device)), golds_g, dp)
        if seen != dp * Wg * 2 * gop:
            raise RuntimeError(f"dryrun_multichip: gop leg saw {seen}")

    # bc on dp
    _check_dense(VideoIngestPipeline(
        [MemorySource(a) for a in avis],
        IngestConfig(window=3, sp_device_path="bc", mesh=mesh_dp,
                     emit_model_input=False, device=device)),
        golds, n_devices)

    # lane containers on dp (raw payload)
    conts = [transcode_to_lane(a, window=3, K=2) for a in avis]
    _check_dense(VideoIngestPipeline(
        [MemorySource(c) for c in conts],
        IngestConfig(sp_device_path="lane", mesh=mesh_dp,
                     emit_model_input=False, device=device)),
        golds, n_devices, mask=0x00FFFFFF)

    if gop == 1:
        return
    # lane gop grouping: restart windows of one stream over the gop axis,
    # raw (every stream, on the mesh) and rans (one stream, no mesh)
    conts_g = [transcode_to_lane(a, window=Wg, K=2) for a in avis_g]
    conts_r = [transcode_to_lane(a, window=Wg, K=2, payload="rans")
               for a in avis_g[:1]]
    for srcs, check_b in ((conts_g, dp), (conts_r, 1)):
        seen = _check_dense(VideoIngestPipeline(
            [MemorySource(c) for c in srcs],
            IngestConfig(sp_device_path="lane",
                         mesh=mesh if len(srcs) == dp else None,
                         emit_model_input=False, device=device)),
            golds_g, check_b, mask=0x00FFFFFF)
        if seen != check_b * Wg * 2 * gop:
            raise RuntimeError(f"dryrun_multichip: lane gop leg saw {seen}")

    # a ragged gop group: keyframes at 0 and 3, window=4 → restart windows
    # of 3 and 4 frames in ONE dispatch
    avis_r, golds_r = _keyframe_avis(rng, dp, 7, lambda t: t in (0, 3),
                                     lambda b: (33, b, 77))
    conts_r = [transcode_to_lane(a, window=4, K=2) for a in avis_r]
    c0 = lane_format.container_from_bytes(conts_r[0])
    if [w.T for w in c0.windows] != [3, 4] or \
            not all(w.restart for w in c0.windows):
        raise RuntimeError("dryrun_multichip: ragged windows not [3, 4] "
                           "restarts")
    seen = _check_dense(VideoIngestPipeline(
        [MemorySource(c) for c in conts_r],
        IngestConfig(sp_device_path="lane", mesh=mesh,
                     emit_model_input=False, device=device)),
        golds_r, dp, mask=0x00FFFFFF)
    if seen != dp * 7:
        raise RuntimeError(f"dryrun_multichip: ragged leg saw {seen}")


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4,
                     sys.argv[2] if len(sys.argv) > 2 else "cuda")
    print("dryrun_multichip ok")

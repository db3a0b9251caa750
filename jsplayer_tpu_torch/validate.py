"""Parity legs of scripts/tpu_validate.py, run through the port.

    python -m jsplayer_tpu_torch.validate [--device cpu]

Builds the script's stream (256x128 SP v4, a keyframe and six P-frames
that alternate a 4-row scroll and a painted rectangle) with the port's
encoder, decodes it on the host, and runs each leg through the port on
`device` (the card by default; "cpu" runs the plain twins):

  xla_parity           sp_recon.decode_sequence (csrc/sp_motion.cu, general)
  pallas_patch_parity  sp_motion_pallas.decode_sequence_fused (fused mode)
  mxu_parity           sp_motion_mxu.compose_frame_mxu_safe (mxu mode) on
                       frame 1's commands against sp_recon.compose_frame
  kmv_native_parity    native kmv transport, then decode_sequence_kmv
                       (csrc/kmv_compose.cu)
  kmv_sparse_parity    native sparse transport (decompress_kmv_sparse a
                       frame, every frame's tiles at M = NB), then
                       decode_batch_kmv_sparse (csrc/kmv_sparse.cu)
  bc_parity            native bc transport, then decode_sequence_bc
                       (csrc/bc_compose.cu)
  lane_raw_parity      transcode_to_lane (raw payload) of the stream, then
                       lane_recon.decode_window_raw (csrc/bc_compose.cu,
                       lane instance); the window must use unit dedup
  lane_rans_parity     the same with the rans payload through
                       decode_window_lane (csrc/rans_lanes.cu, then the
                       lane instance)
  lane_ragged_parity   a 14-frame stream with keyframes every 5 frames,
                       transcoded into keyframe-snapped (ragged) windows,
                       through VideoIngestPipeline(sp_device_path="lane")

Every leg but mxu_parity holds each decoded frame against the source frame
(the lane legs on the low 24 bits, as the script does).  It prints one
JSON line {leg: bool} and exits 1 when a leg is False.  Nothing is caught:
a leg that fails to run raises.  The script's bench and its
TPU_RESULTS.md append are not ported.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from . import native
from .codecs import lane_format
from .core.source import MemorySource
from .device import resolve_device, to_device, torch_to_u32
from .encode.avi_mux import mux_avi
from .encode.sp_enc import ScreenPressorEncoder, pack_rgb
from .kernels import lane_recon, sp_recon
from .kernels.sp_motion_mxu import compose_frame_mxu_safe
from .kernels.sp_motion_pallas import decode_sequence_fused
from .pipeline.batch import stack_sp_commands
from .transcode import transcode_to_lane

X, Y = 256, 128
K = 2


def make_stream(rng=None) -> tuple[list[bytes], list[np.ndarray]]:
    """tpu_validate.py's stream → (frame chunks, source frames [Y*X] u32).
    The script draws its paint colours from rng = default_rng(0), and its
    ragged stream (make_ragged_stream) goes on drawing from the same rng."""
    enc = ScreenPressorEncoder(4, X, Y)
    rng = np.random.default_rng(0) if rng is None else rng
    f = np.full((Y, X), pack_rgb(7, 7, 7), dtype=np.uint32).reshape(-1)
    streams, golds = [enc.encode_i(f)], [f]
    for t in range(6):
        nf = f.copy().reshape(Y, X)
        if t % 2 == 0:
            nf[4:, :] = nf[:-4, :].copy()
        else:
            nf[10:30, 40:200] = pack_rgb(*rng.integers(0, 256, 3))
        f = nf.reshape(-1)
        streams.append(enc.encode_p(f))
        golds.append(f)
    return streams, golds


def make_ragged_stream(rng) -> tuple[bytes, list[np.ndarray]]:
    """tpu_validate.py's ragged-window stream: 14 frames, keyframes every 5,
    paints on two frames of three → (AVI bytes, source frames [Y*X])."""
    enc = ScreenPressorEncoder(4, X, Y)
    fr = np.full((Y, X), pack_rgb(5, 6, 7), dtype=np.uint32)
    streams, golds, keys = [], [], []
    for t in range(14):
        fr = fr.copy()
        if t % 3 != 2:
            fr[(t % 5) * 8: (t % 5) * 8 + 8, 8:40] = pack_rgb(
                *rng.integers(0, 256, 3))
        isk = t % 5 == 0
        if isk:
            enc = ScreenPressorEncoder(4, X, Y)
        flat = fr.reshape(-1).copy()
        streams.append(enc.encode_i(flat) if isk else enc.encode_p(flat))
        golds.append(flat)
        keys.append(isk)
    return mux_avi(streams, X, Y, 24, codec="SPV4", keyflags=keys), golds


class Legs:
    """The stream, its host decode and the device; one method a leg, each
    → bool."""

    def __init__(self, device):
        self.dev = resolve_device(device)
        rng = np.random.default_rng(0)
        self.streams, self.golds = make_stream(rng)
        self.ragged_avi, self.ragged_golds = make_ragged_stream(rng)
        self.cmds = {k: v[0, 0] for k, v in
                     stack_sp_commands([self.streams], X, Y).items()}
        if not native.available():
            raise RuntimeError("the native host library did not build: the "
                               "kmv_native, kmv_sparse and bc legs need it")

    def put(self, a: np.ndarray) -> torch.Tensor:
        return to_device(a, self.dev)

    def zero(self) -> torch.Tensor:
        return torch.zeros((Y, X), dtype=torch.int32, device=self.dev)

    def matches(self, frames: torch.Tensor) -> bool:
        got = torch_to_u32(frames)
        return len(got) == len(self.golds) and all(
            np.array_equal(got[t].reshape(-1), g)
            for t, g in enumerate(self.golds))

    def block_args(self):
        c = self.cmds
        return (self.zero(), *(self.put(c[k]) for k in (
            "bts", "mv", "rect", "payload", "changed")), 0)

    def xla_parity(self) -> bool:
        return self.matches(sp_recon.decode_sequence(*self.block_args())[0])

    def pallas_patch_parity(self) -> bool:
        return self.matches(decode_sequence_fused(*self.block_args())[0])

    def mxu_parity(self) -> bool:
        """Frame 1's commands on the source frame 0 (tpu_validate.py's
        construction of the MXU inputs)."""
        bts, mv, rect, payload = (self.cmds[k][1] for k in (
            "bts", "mv", "rect", "payload"))
        nbx = X // 16
        yy, xx = np.mgrid[0:Y, 0:X]
        bi = (yy >> 4) * nbx + (xx >> 4)
        b, r = bts[bi], rect[bi]
        in_rect = ((xx >= r[..., 0]) & (xx < r[..., 2])
                   & (yy >= r[..., 1]) & (yy < r[..., 3]))
        is_data = (b > 0) & (b != 3) & in_rect
        paycode = (payload & 0xFFFFFF) | (is_data.astype(np.uint32) << 24)
        blk = np.arange(bts.shape[0])
        src_yx = np.stack([(blk // nbx) * 16 + mv[:, 1],
                           (blk % nbx) * 16 + mv[:, 0]], -1)
        prev = self.put(self.golds[0].reshape(Y, X))
        out = compose_frame_mxu_safe(
            prev, self.put(paycode), self.put(src_yx.astype(np.int32)),
            self.put((bts == 3).astype(np.int32)))
        want = sp_recon.compose_frame(prev, *(self.put(a) for a in (
            bts, mv, rect, payload)))
        return bool(torch.equal(out, want))

    def kmv_native_parity(self) -> bool:
        kmv = native.native_sp_decode_streams_kmv([self.streams], X, Y, K=K)
        return self.matches(sp_recon.decode_sequence_kmv(
            self.zero(), *(self.put(kmv[k][0]) for k in (
                "paycode", "mvk", "changed"))))

    def kmv_sparse_parity(self) -> bool:
        """Per-frame native sparse emission into dense [T, NB] tile rows,
        then the batched sparse scan of one stream (tpu_validate.py's leg:
        the keyframe's tiles must fit M = NB)."""
        d = native.NativeScreenPressor(X, Y, 24)
        d.preinit(0)
        nb = d.nbx * d.nby
        T = len(self.streams)
        bc = np.zeros((T, nb), np.uint8)
        mvk = np.zeros((T, K, 2), np.int32)
        tiles = np.zeros((T, nb, 16, 16), np.uint32)
        tyx = np.zeros((T, nb, 2), np.int32)
        chg = np.zeros(T, bool)
        fits = True
        for t, st in enumerate(self.streams):
            chg[t], _, m_used = d.decompress_kmv_sparse(
                st, d.is_key_frame(st), bc[t], mvk[t], tiles[t], tyx[t], K=K)
            if t == 0:
                fits = m_used <= nb
        frames = sp_recon.decode_batch_kmv_sparse(
            self.zero()[None], *(self.put(a[None]) for a in (
                bc, mvk, tiles, tyx, chg)))
        return fits and self.matches(frames[0])

    def bc_parity(self) -> bool:
        bc = native.native_sp_decode_streams_bc([self.streams], X, Y, K=K)
        return self.matches(sp_recon.decode_sequence_bc(
            self.zero(), *(self.put(bc[k][0]) for k in (
                "plane", "bcode", "rloc", "mvk", "changed"))))

    def lane_window(self, mode: str):
        """The stream's single lane window in payload `mode` → (window,
        row_table, row_idx, commands btype/rect/mvk/.../changed on the
        device)."""
        avi = mux_avi(self.streams, X, Y, 24, codec="SPV4",
                      keyflags=[t == 0 for t in range(len(self.streams))])
        cont = lane_format.container_from_bytes(transcode_to_lane(
            avi, window=len(self.streams), K=K, payload=mode))
        w = cont.windows[0]
        rt, ri = w.row_index(Y, lane_format.plane_cols(X) // 128)
        return w, [self.put(a) for a in (w.btype, w.rect, w.mvk, rt, ri,
                                         w.changed)]

    @staticmethod
    def matches24(got, golds) -> bool:
        """Frames got (u32, [T, ...]) equal golds on their low 24 bits."""
        return len(got) == len(golds) and all(
            np.array_equal(got[t].reshape(-1) & 0x00FFFFFF, g & 0x00FFFFFF)
            for t, g in enumerate(golds))

    def lane_raw_parity(self) -> bool:
        w, cmds = self.lane_window("raw")
        frames = lane_recon.decode_window_raw(self.zero(),
                                              self.put(w.payload), *cmds)
        return (self.matches24(torch_to_u32(frames), self.golds)
                and w.unit_idx is not None)

    def lane_rans_parity(self) -> bool:
        w, cmds = self.lane_window("rans")
        init = (self.put(w.init_plane) if w.init_plane is not None
                else self.zero())
        frames = lane_recon.decode_window_lane(
            init, self.put(w.refills), self.put(w.states), self.put(w.freq),
            *cmds, U=w.n_units)
        return self.matches24(torch_to_u32(frames), self.golds)

    def lane_ragged_parity(self) -> bool:
        """Keyframe-snapped windows of several lengths through the whole
        lane ingest (Tpad bucketing, frame bases by prefix sums)."""
        from .pipeline.ingest import IngestConfig, VideoIngestPipeline

        cont = transcode_to_lane(self.ragged_avi, window=4, K=K)
        lengths = {w.T for w in lane_format.container_from_bytes(
            cont).windows}
        pipe = VideoIngestPipeline(
            [MemorySource(cont)],
            IngestConfig(sp_device_path="lane", device=str(self.dev)))
        got = {}
        for batch in pipe:
            arr = torch_to_u32(batch["frames_u32"])
            for t in range(arr.shape[1]):
                got[batch["start_frame"] + t] = arr[0, t]
        return (len(lengths) > 1 and sorted(got) == list(range(len(
            self.ragged_golds))) and self.matches24(
                [got[t] for t in sorted(got)], self.ragged_golds))


LEGS = ("xla_parity", "pallas_patch_parity", "mxu_parity",
        "kmv_native_parity", "kmv_sparse_parity", "bc_parity",
        "lane_raw_parity", "lane_rans_parity", "lane_ragged_parity")


def run(device="cuda") -> dict[str, bool]:
    """Every leg on `device` → {leg: bool}."""
    legs = Legs(device)
    res = {name: getattr(legs, name)() for name in LEGS}
    if legs.dev.type == "cuda":
        torch.cuda.synchronize(legs.dev)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="jsplayer_tpu_torch.validate")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the legs (cuda raises when there "
                         "is no card; cpu runs the plain twins)")
    res = run(ap.parse_args(argv).device)
    print(json.dumps(res), flush=True)
    return 0 if all(res.values()) else 1


if __name__ == "__main__":
    sys.exit(main())

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
  bc_parity            native bc transport, then decode_sequence_bc
                       (csrc/bc_compose.cu)

Every leg but mxu_parity holds each decoded frame against the source
frame.  It prints one JSON line {leg: bool} and exits 1 when a leg is
False.  Nothing is caught: a leg that fails to run raises.  The script's
other legs (kmv_sparse, lane) wait for their paths (ROADMAP.md queue 1);
its bench and its TPU_RESULTS.md append are not ported.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from . import native
from .device import resolve_device, to_device, torch_to_u32
from .encode.sp_enc import ScreenPressorEncoder, pack_rgb
from .kernels import sp_recon
from .kernels.sp_motion_mxu import compose_frame_mxu_safe
from .kernels.sp_motion_pallas import decode_sequence_fused
from .pipeline.batch import stack_sp_commands

X, Y = 256, 128
K = 2


def make_stream() -> tuple[list[bytes], list[np.ndarray]]:
    """tpu_validate.py's stream → (frame chunks, source frames [Y*X] u32)."""
    enc = ScreenPressorEncoder(4, X, Y)
    rng = np.random.default_rng(0)
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


class Legs:
    """The stream, its host decode and the device; one method a leg, each
    → bool."""

    def __init__(self, device):
        self.dev = resolve_device(device)
        self.streams, self.golds = make_stream()
        self.cmds = {k: v[0, 0] for k, v in
                     stack_sp_commands([self.streams], X, Y).items()}
        if not native.available():
            raise RuntimeError("the native host library did not build: the "
                               "kmv_native and bc legs need it")

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

    def bc_parity(self) -> bool:
        bc = native.native_sp_decode_streams_bc([self.streams], X, Y, K=K)
        return self.matches(sp_recon.decode_sequence_bc(
            self.zero(), *(self.put(bc[k][0]) for k in (
                "plane", "bcode", "rloc", "mvk", "changed"))))


LEGS = ("xla_parity", "pallas_patch_parity", "mxu_parity",
        "kmv_native_parity", "bc_parity")


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

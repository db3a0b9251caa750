"""The in-scan ds2 experiment of scripts/exp_model_fusion2.py on the card.

    python -m jsplayer_tpu_torch.experiments.exp_model_fusion2 [--nchw]

The kmv scan over one 1080p bench-mix stream (streams.py: T=64 frames,
compacted to its changed frames), emitting 2×2-downsampled model tensors
in seven ways:

  A         decode_sequence_kmv_compact_model(downscale=2): kmv_compose,
            then ds2_pack with the row flip, each step; unpack after the
            scan (the ingest path)
  E1        one kmv_compose_ds2 launch a step: compose and the packed ds2
            plane together (the script's Pallas ds2 inside the scan step);
            unpack_small after the scan
  E2        the kmv_compose scan to a full-res stack, then one ds2_pack
            over it (two passes)
  A_nchw    A in NCHW
  E1_nchw   E1 unpacked to NCHW
  E1_packed E1's packed planes themselves (the consumer unpacks)
  Arw_nchw  to_model_input(downscale=2, layout="NCHW") each step

Every variant must equal A bit for bit (the NCHW ones A moved to NCHW;
E1_packed once unpacked).  Times are CUDA events around repeated calls
after warm-up; delivered fps counts timeline frames (stills included, as
the script counts them) per second.  main() runs A, E1, E2; --nchw runs
the NCHW and packed forms (the script's main2).
"""

from __future__ import annotations

import sys

import torch

from ..device import to_device
from ..kernels.rgb_convert import ds2_pack, to_model_input
from ..kernels.sp_recon import (decode_sequence_kmv_compact,
                                decode_sequence_kmv_compact_model,
                                kmv_compose, kmv_compose_ds2)
from .common import card, require_parity, same_bits, time_ms
from .streams import bench_mix_kmv

Y, X = 1080, 1920
T = 64

_QUARTER = torch.tensor(1.0 / (255.0 * 4.0), dtype=torch.float32)


def _channels(red: torch.Tensor, dtype) -> torch.Tensor:
    """Packed planes → [..., 3, H, W] (R, G, B) scaled, rows flipped."""
    x = torch.stack([(red >> 20) & 1023, (red >> 10) & 1023, red & 1023],
                    dim=-3)
    x = torch.flip(x, dims=[-2])
    return (x.to(torch.float32) * _QUARTER).to(dtype)


def unpack_small(red: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Packed [..., H, W] i32 → [..., H, W, 3] model tensors (NHWC)."""
    return _channels(red, dtype).movedim(-3, -1)


def unpack_nchw(red: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Packed [..., H, W] i32 → [..., 3, H, W] model tensors."""
    return _channels(red, dtype)


def _scan(init, steps: int, step) -> None:
    """The compact kmv scan over two ping-pong frame buffers: step(prev,
    out, t) composes frame t of `steps` into `out`."""
    bufs = (torch.empty_like(init[None]), torch.empty_like(init[None]))
    prev = init[None]
    for t in range(steps):
        step(prev, bufs[t % 2], t)
        prev = bufs[t % 2]


def _scan_ds2(init, pc, mvk) -> torch.Tensor:
    """E1's scan: one kmv_compose_ds2 launch a step, each writing its
    packed plane straight into the [T', Y/2, X/2] stack."""
    Tc, (Yi, Xi) = pc.shape[0], init.shape
    red = torch.empty((Tc, Yi // 2, Xi // 2), dtype=torch.int32,
                      device=init.device)
    chg = torch.ones(1, dtype=torch.bool, device=init.device)
    _scan(init, Tc, lambda prev, out, t: kmv_compose_ds2(
        prev, pc[t][None], mvk[t][None], chg, out=out, red=red[t][None]))
    return red


def variant_A(init, pc, mvk):
    return decode_sequence_kmv_compact_model(init, pc, mvk, downscale=2)[1]


def variant_A_nchw(init, pc, mvk):
    return decode_sequence_kmv_compact_model(init, pc, mvk, downscale=2,
                                             layout="NCHW")[1]


def variant_E1(init, pc, mvk):
    return unpack_small(_scan_ds2(init, pc, mvk))


def variant_E1_nchw(init, pc, mvk):
    return unpack_nchw(_scan_ds2(init, pc, mvk))


def variant_E1_packed(init, pc, mvk):
    """Minimal contract: packed 10-bit field sums, consumer unpacks."""
    return _scan_ds2(init, pc, mvk)


def variant_E2(init, pc, mvk):
    frames = decode_sequence_kmv_compact(init, pc, mvk)
    return unpack_small(ds2_pack(frames, flip=False))


def variant_Arw_nchw(init, pc, mvk):
    """A's unfused epilogue, NCHW all the way: to_model_input each step."""
    chg = torch.ones(1, dtype=torch.bool, device=init.device)
    ys = []

    def step(prev, out, t):
        kmv_compose(prev, pc[t][None], mvk[t][None], chg, out=out)
        ys.append(to_model_input(out[0], downscale=2, layout="NCHW"))

    _scan(init, pc.shape[0], step)
    return torch.stack(ys)


#: name → (variant, how it compares with A: "NHWC" equal, "NCHW" equal to
#: A moved to NCHW, "packed" equal once unpack_small'd)
VARIANTS = {
    "A": (variant_A, "NHWC"),
    "E1": (variant_E1, "NHWC"),
    "E2": (variant_E2, "NHWC"),
    "A_nchw": (variant_A_nchw, "NCHW"),
    "E1_nchw": (variant_E1_nchw, "NCHW"),
    "E1_packed": (variant_E1_packed, "packed"),
    "Arw_nchw": (variant_Arw_nchw, "NCHW"),
}
MAIN = ("A", "E1", "E2")
MAIN2 = ("A_nchw", "E1_nchw", "E1_packed", "Arw_nchw")


def equals_A(got: torch.Tensor, a: torch.Tensor, kind: str) -> bool:
    if kind == "NCHW":
        return same_bits(got, a.movedim(-1, -3))
    if kind == "packed":
        return got.dtype == torch.int32 and same_bits(unpack_small(got), a)
    return same_bits(got, a)


def run(init, pc, mvk, names=tuple(VARIANTS), timeline_frames: int = T,
        iters: int = 10) -> dict:
    """Each named variant on the compacted transport (tensors on one
    device) → {name: {"parity": equal to A, "ms": per call, "fps":
    delivered timeline frames/s}}; times on the card only (None on the
    CPU)."""
    a = variant_A(init, pc, mvk)
    res = {}
    for name in names:
        fn, kind = VARIANTS[name]
        r = {"parity": equals_A(fn(init, pc, mvk), a, kind), "ms": None,
             "fps": None}
        if init.is_cuda:
            r["ms"] = time_ms(lambda: fn(init, pc, mvk), iters)
            r["fps"] = timeline_frames / (r["ms"] / 1e3)
        res[name] = r
    return res


def load_stream(device, Y: int = Y, X: int = X, T: int = T):
    """The bench-mix stream's compacted kmv transport on `device` →
    (init [Y, X] zeros, paycode [T', Y, X], mvk [T', K, 2], T')."""
    pcc, mvkc, _ = bench_mix_kmv(Y, X, T)
    init = torch.zeros((Y, X), dtype=torch.int32, device=device)
    return init, to_device(pcc, device), to_device(mvkc, device), len(pcc)


def _main(names) -> None:
    dev, card_line = card()
    init, pc, mvk, nchanged = load_stream(dev)
    res = run(init, pc, mvk, names)
    print(f"card: {card_line}")
    print(f"bench-mix stream {X}x{Y}, {T} frames, {nchanged} changed")
    for name, r in res.items():
        print(f"{name}: parity {'ok' if r['parity'] else 'FAILED'} vs A; "
              f"{r['ms']:.4f} ms/call, {r['fps']:,.0f} delivered fps")
    require_parity(res, "exp_model_fusion2 (variants against A)")


def main() -> None:
    _main(MAIN)


def main2() -> None:
    _main(MAIN2)


if __name__ == "__main__":
    main2() if "--nchw" in sys.argv[1:] else main()

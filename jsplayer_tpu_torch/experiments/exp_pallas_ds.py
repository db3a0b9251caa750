"""The ds2 layout variants of scripts/exp_pallas_ds.py on the card.

    python -m jsplayer_tpu_torch.experiments.exp_pallas_ds

The script wrote one Pallas kernel in six variants, each a different way to
pair rows and columns inside a [BH, X] VMEM tile, and held them against
``rw22`` (the XLA reduce_window of the packed fields).  On Hopper the
layout question does not arise; what the variants compute does:

  tpose, reshape, slice, take  rw22 exactly → ds_probe mode ds2_fields
                               (pack each pixel, add four words)
  tpose16                      per-channel 16-bit pair sums, rw22 exactly
                               → csrc/ds2_pack.cu (ds2_pack, no flip)
  bitcast                      the u16→u32 bitcast pairs ROWS, so the
                               variant folds the right half of each row
                               pair onto the left (probes.bitcast_fold_ref)
                               → ds_probe mode bitcast_fold; it differs
                               from rw22 by design, and its own twin is
                               its reference

main() runs every variant on a [64, 1080, 1920] random stack: parity, ms
per call beside the plain twin, frames/s and µs/frame.
"""

from __future__ import annotations

import torch

from ..kernels.ds_probe import ds_probe
from ..kernels.rgb_convert import ds2_pack
from .common import card, fmt_ms, measure, rand_frames, require_parity
from .probes import bitcast_fold_ref, rw22

Y, X = 1080, 1920
T = 64
BH = 128  # the Pallas block height: 1080 = 8*128 + 56, a partial last block

VARIANTS = ("tpose", "tpose16", "bitcast", "reshape", "slice", "take")
_FIELDS = ("tpose", "reshape", "slice", "take")


def ds2_pallas(frames: torch.Tensor, variant: str = "slice") -> torch.Tensor:
    """[C, Y, X] u32 (int32 bits) → [C, Y//2, X//2] i32, as the script's
    variant computes it."""
    if variant == "tpose16":
        return ds2_pack(frames, flip=False)
    if variant in _FIELDS:
        return ds_probe(frames, "ds2_fields", BH)
    if variant == "bitcast":
        return ds_probe(frames, "bitcast_fold", BH)
    raise ValueError(f"unknown variant {variant!r}")


def twin(variant: str):
    """The plain reference a variant is held to."""
    return bitcast_fold_ref if variant == "bitcast" else rw22


def run(frames: torch.Tensor, iters: int = 20) -> dict:
    """Every variant on `frames` → {variant: measure(...) + "equals_rw22"}."""
    ref = rw22(frames)
    res = {}
    for v in VARIANTS:
        r = measure(lambda f, v=v: ds2_pallas(f, v), twin(v), frames, iters)
        r["equals_rw22"] = torch.equal(ds2_pallas(frames, v), ref)
        res[v] = r
    return res


def main() -> None:
    dev, card_line = card()
    frames = rand_frames((T, Y, X), dev)
    res = run(frames)
    print(f"card: {card_line}")
    for v, r in res.items():
        fps = T / (r["ms"] / 1e3)
        note = ("equals rw22" if r["equals_rw22"] else
                "differs from rw22 by design (row-pair + half-width fold)")
        print(f"{v}: parity {'ok' if r['parity'] else 'FAILED'} vs "
              f"{twin(v).__name__}, {note}; kernel {fmt_ms(r['ms'])} "
              f"({fps:,.0f} fps, {1e6 / fps:.2f} us/frame), plain "
              f"{fmt_ms(r['plain_ms'])} per [{T},{Y},{X}]")
    require_parity(res, "exp_pallas_ds")


if __name__ == "__main__":
    main()

"""The Mosaic lowering probes of scripts/exp_pallas_bisect.py on the card.

    python -m jsplayer_tpu_torch.experiments.exp_pallas_bisect

The script bisected which in-kernel op Mosaic could not lower, with seven
small Pallas kernels over a [4, 1080, 1920] stack in 128-row blocks.  On
Hopper nothing needs bisecting; each probe becomes the ds_probe mode that
computes the same words (probes.py):

  sub_slice, sub_reshape, sub_roll  int32 row-pair sums    → hpair_i32
  bitcast_h                         low-byte row-pair sums → hpair_lowbyte
  minor_reshape, lane_gather_same   int32 column-pair sums → wpair_i32
  transpose                         per-block transpose    → block_transpose

main() checks each against its plain twin (on random words, where the
script fed zeros) and prints ms per call beside the twin's.
"""

from __future__ import annotations

from .common import card, rand_frames
from .exp_pallas_ds2 import report, run as run_cases

Y, X = 1080, 1920
T = 4
BH = 128

CASES = {"sub_slice": "hpair_i32", "sub_reshape": "hpair_i32",
         "sub_roll": "hpair_i32", "bitcast_h": "hpair_lowbyte",
         "minor_reshape": "wpair_i32", "lane_gather_same": "wpair_i32",
         "transpose": "block_transpose"}


def run(frames, bh: int = BH, iters: int = 20) -> dict:
    """Every probe's ds_probe mode on `frames` in blocks of `bh` rows →
    {probe: measure(...)}."""
    return run_cases(frames, CASES, bh, iters)


def main() -> None:
    dev, card_line = card()
    report("exp_pallas_bisect", card_line, CASES,
           run(rand_frames((T, Y, X), dev)), T)


if __name__ == "__main__":
    main()

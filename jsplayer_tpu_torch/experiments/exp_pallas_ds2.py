"""The cost-isolation probes of scripts/exp_pallas_ds2.py on the card.

    python -m jsplayer_tpu_torch.experiments.exp_pallas_ds2

The script timed three Pallas kernels over a [64, 1080, 1920] stack in
128-row blocks to tell read cost, VPU cost and transpose cost apart.  Each
becomes a ds_probe mode computing the same words (probes.py):

  passthru      each block's top-left [64, 960]        → mode passthru
  pack_h        packed row-pair sums, first 960 cols   → mode pack_h
  tpose16_notr  packed FOUR-row sums, first 960 cols   → mode sum4

main() checks each against its plain twin and prints ms per call beside
the twin's.
"""

from __future__ import annotations

from ..kernels.ds_probe import ds_probe
from .common import card, fmt_ms, measure, rand_frames, require_parity
from .probes import probe_ref

Y, X = 1080, 1920
T = 64
BH = 128

CASES = {"passthru": "passthru", "pack_h": "pack_h", "tpose16_notr": "sum4"}


def run(frames, cases=CASES, bh: int = BH, iters: int = 20) -> dict:
    """Every case's ds_probe mode on `frames` in blocks of `bh` rows →
    {case: measure(...)}."""
    return {name: measure(lambda f, m=mode: ds_probe(f, m, bh),
                          lambda f, m=mode: probe_ref(f, m, bh),
                          frames, iters)
            for name, mode in cases.items()}


def report(title: str, card_line: str, cases: dict, res: dict, T: int
           ) -> None:
    print(f"card: {card_line}")
    for name, r in res.items():
        us = "" if r["ms"] is None else f", {r['ms'] * 1e3 / T:.2f} us/frame"
        print(f"{title} {name} (mode {cases[name]}) -> {r['shape']}: parity "
              f"{'ok' if r['parity'] else 'FAILED'}; kernel "
              f"{fmt_ms(r['ms'])}{us}, plain {fmt_ms(r['plain_ms'])}")
    require_parity(res, title)


def main() -> None:
    dev, card_line = card()
    report("exp_pallas_ds2", card_line, CASES,
           run(rand_frames((T, Y, X), dev)), T)


if __name__ == "__main__":
    main()

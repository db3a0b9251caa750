"""The plain reference of the ScreenPressor and MSVideo1 deployments.

The codecs are lossless, so a delivered frame is judged against the
source frame the cell's recipe drew, on its 24 pixel bits (the lane
transport may leave other bits in the top byte).  A model tensor is judged
against ``model``: the ds2 epilogue written out in plain torch ops from
the description of ``IngestConfig(model_downscale=2)``: per channel the
sum of each 2x2 box of 8-bit values (R the word's bits 16-23), the rows
flipped (bottom-up storage to a top-down tensor), times the float32
constant (1/255)/4, rounded to the configuration's model dtype, NHWC.  It
imports nothing of the port.

``control`` is this reference put in the program's place one precision
below what the configuration states, as its ``control`` entry gives it:
frames through a coarser pixel lattice (RGB565 below 24-bit frames,
RGB444 below MSVideo1's RGB555) and model tensors through float8 e4m3
(the step below bfloat16).  It has to fail.

Every comparison is exact, so every limit is 0.
"""

from __future__ import annotations

import torch

PIXEL_MASK = 0xFFFFFF
LIMITS = {"frame_px_wrong": 0, "model_elems_wrong": 0}


def _box2(p: torch.Tensor) -> torch.Tensor:
    Ho, Wo = p.shape[-2] // 2, p.shape[-1] // 2
    p = p[..., : 2 * Ho, : 2 * Wo]
    return (p[..., 0::2, 0::2] + p[..., 0::2, 1::2]
            + p[..., 1::2, 0::2] + p[..., 1::2, 1::2])


def model(frames: torch.Tensor, cfg: dict, dtype=None) -> torch.Tensor:
    """frames [n, Y, X] int32 (u32 bits) → model tensors [n, Y/2, X/2, 3]
    in the configuration's model dtype (or `dtype`)."""
    ing = cfg["ingest"]
    if ing.get("model_downscale") != 2:
        raise ValueError("this reference computes the ds2 epilogue only")
    x = torch.stack([_box2((frames >> s) & 0xFF) for s in (16, 8, 0)],
                    dim=-1)
    x = torch.flip(x, dims=[-3]) << cfg.get("model_shift", 0)
    scale = torch.tensor((1.0 / 255.0) / 4.0, dtype=torch.float32)
    return (x.to(torch.float32) * scale).to(
        dtype or getattr(torch, ing["model_dtype"]))


def control(frames: torch.Tensor, cfg: dict) -> tuple:
    """The control's (frames, model tensors) of source frames [n, Y, X]."""
    ctl = cfg["control"]
    dt = getattr(torch, cfg["ingest"]["model_dtype"])
    return (frames & int(ctl["pixel_mask"], 16),
            model(frames, cfg, dtype=getattr(torch, ctl["model_dtype"]))
            .to(dt))

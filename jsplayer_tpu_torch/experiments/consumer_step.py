"""The packed-ds2 consumer on the card: packed_consumer_step at ViT-B/16's
patch embed (16x16 patches, 3 -> 768, bf16) on the [64, 540, 960] packed
planes of one 64-frame 1080p window, beside ds2_pack's own time on the
same window.

    python -m jsplayer_tpu_torch.experiments.consumer_step

prints one JSON line: the card's name and power limit; ds2_pack's ms on
the [64, 1080, 1920] frames; unpack_ds2's ms alone; the patch-embed's ms
alone as the port computes it (one matrix product, `matmul`) and as one
cuDNN convolution (`conv2d`, the yardstick the port does not call); the
whole step's ms by each; the step's operations, bytes and bound.  Every
ms is CUDA events around calls (`ms`) and the same calls replayed as a
CUDA graph (`graph_ms`).  chip_smoke.py's phase (t) calls time_consumer.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from .common import HBM_BYTES_PER_MS, card, graph_ms, io_bytes, \
    rand_frames, time_ms

#: one 64-frame window of 1080p frames, and ViT-B/16's patch embed
FRAMES = (64, 1080, 1920)
PATCH, WIDTH = 16, 768
#: NVIDIA H100 SXM dense bf16 tensor-core peak, operations a ms
BF16_OPS_PER_MS = 989e9


def vit_b16_weights(device, seed: int = 0) -> torch.Tensor:
    """[16, 16, 3, 768] bf16 patch-embed weights made from `seed`."""
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 0.02, (PATCH, PATCH, 3, WIDTH)).astype(np.float32)
    return torch.from_numpy(w).to(device=device, dtype=torch.bfloat16)


def conv2d_embed(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The patch embed as one cuDNN convolution: NHWC x as a channels-last
    NCHW view, HWIO w as OIHW → [N, H', W', D] (a view of the
    channels-last output)."""
    out = torch.nn.functional.conv2d(
        x.permute(0, 3, 1, 2), w.to(x.dtype).permute(3, 2, 0, 1),
        stride=tuple(w.shape[:2]))
    return out.permute(0, 2, 3, 1)


def consumer_ops(red: torch.Tensor, w: torch.Tensor) -> int:
    """Multiply-adds of the patch embed on `red`'s planes, two operations
    each (the unpack's integer work is a few operations a word, far
    under the bytes)."""
    ph, pw, c, d = w.shape
    n = red.shape[0] * (red.shape[1] // ph) * (red.shape[2] // pw)
    return 2 * n * ph * pw * c * d


def bound(red, w, out) -> dict:
    """The least time of one step: the planes and weights read once and
    the embeddings written once over 3.35 TB/s, against its operations
    over the bf16 peak; the larger bounds it."""
    nbytes, ops = io_bytes(red, w, out), consumer_ops(red, w)
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_MS, ops / BF16_OPS_PER_MS
    return dict(bytes=nbytes, ops=ops, bound_ms=max(by_bytes, by_ops),
                bound_by="operations" if by_ops >= by_bytes else "bytes")


def both(fn) -> dict:
    return dict(ms=time_ms(fn), graph_ms=graph_ms(fn))


def time_consumer(device, yardstick: bool = True) -> dict:
    """The numbers of one call at FRAMES (see the module's docstring), with
    the largest difference between the two patch embeds' outputs; without
    the cuDNN convolution's numbers unless `yardstick`."""
    from ..kernels.rgb_convert import (ds2_pack, packed_consumer_step,
                                       patch_embed, unpack_ds2)

    frames = rand_frames(FRAMES, device, seed=7) & 0x00FFFFFF
    w = vit_b16_weights(device)
    red = ds2_pack(frames, flip=True)
    x = unpack_ds2(red, flip_vertical=False)
    res = {"frames": list(FRAMES), "planes": list(red.shape),
           "weights": list(w.shape)}
    res["ds2_pack"] = both(lambda: ds2_pack(frames, flip=True))
    del frames
    res["unpack_ds2"] = both(lambda: unpack_ds2(red, flip_vertical=False))
    res["patch_embed"] = {"matmul": both(lambda: patch_embed(x, w))}
    res["packed_consumer_step"] = {
        "matmul": both(lambda: packed_consumer_step(red, w))}
    out = packed_consumer_step(red, w)
    if yardstick:
        res["patch_embed"]["conv2d"] = both(lambda: conv2d_embed(x, w))
        res["packed_consumer_step"]["conv2d"] = both(lambda: conv2d_embed(
            unpack_ds2(red, flip_vertical=False), w))
        res["conv2d_vs_matmul_max_abs"] = float(
            (conv2d_embed(x, w).float() - out.float()).abs().max())
    res.update(bound(red, w, out))
    return res


def main() -> None:
    device, line = card()
    print(json.dumps(dict(card=line, **time_consumer(device))), flush=True)


if __name__ == "__main__":
    main()

"""ML-ingestion model epilogue: u32 frames → normalized model tensors.

Counterpart of jsplayer_tpu/kernels/rgb_convert.py, with the same layouts
and argument names at the public functions.  Frames are int32 tensors
holding u32 bits (see device.py); `dtype` is a torch dtype.

``ds2_pack`` is the CUDA kernel csrc/ds2_pack.cu for tensors on the card
and its plain twin ``ds2_pack_ref`` for tensors on the CPU.  Everything
else here is plain torch, as it was XLA (not Pallas) in the JAX package.
``to_model_input(downscale=2)`` routes through ``ds2_pack`` +
``unpack_ds2``: integer sums then one f32 multiply, bit-exact against the
unfused epilogue.
"""

from __future__ import annotations

import torch

from .. import _build
from ..device import cuda_launch_checks


def _flip_rows(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Vertical flip (bottom-up storage → top-down tensor)."""
    return torch.flip(x, dims=[axis])


def _box2(p: torch.Tensor) -> torch.Tensor:
    """2×2 box sums over the last two axes, reduce_window VALID (an odd
    last row or column is dropped).  int32 wraps like XLA's."""
    Ho, Wo = p.shape[-2] // 2, p.shape[-1] // 2
    p = p[..., : 2 * Ho, : 2 * Wo]
    return (p[..., 0::2, 0::2] + p[..., 0::2, 1::2]
            + p[..., 1::2, 0::2] + p[..., 1::2, 1::2])


def _normalize(x: torch.Tensor, dtype, scale: float, mean: float
               ) -> torch.Tensor:
    """(x.f32 * f32(scale) - f32(mean)).astype(dtype), the JAX epilogue's
    arithmetic: the Python scalars become f32 constants, each op rounds to
    f32, and the cast rounds to nearest even."""
    s = torch.tensor(scale, dtype=torch.float32)
    m = torch.tensor(mean, dtype=torch.float32)
    return (x.to(torch.float32) * s - m).to(dtype)


def to_model_input(
    frame: torch.Tensor,
    dtype=torch.bfloat16,
    layout: str = "NHWC",
    mean: float = 0.0,
    scale: float = 1.0 / 255.0,
    flip_vertical: bool = True,
    bpp16: bool = False,
    downscale: int = 1,
) -> torch.Tensor:
    """u32 [..., H, W] → normalized [..., H/d, W/d, 3] (NHWC) or
    [..., 3, H/d, W/d] (NCHW) in `dtype`, channels (R, G, B) with R the
    u32's high byte (rgb_convert.split_channels' ground-truth note)."""
    d = downscale
    if not (1 <= d <= 16 and (d & (d - 1)) == 0):
        raise ValueError("downscale must be a power of two <= 16 "
                         "(field-sum bound)")
    if d == 2:
        return unpack_ds2(ds2_pack(frame), dtype=dtype, layout=layout,
                          mean=mean, scale=scale,
                          flip_vertical=flip_vertical, bpp16=bpp16)
    c = frame
    p0 = c & 0x00FF00FF  # b | r << 16: two 16-bit fields in one word
    p1 = (c >> 8) & 0xFF  # g
    denom = 1
    while d > 1:
        p0, p1 = _box2(p0), _box2(p1)
        denom *= 4
        d >>= 1
    # `p0 >> 16` is unmasked on purpose, as in the reference: at d=16 a red
    # sum >= 32768 wraps the int32 and the arithmetic shift keeps the sign
    x = torch.stack([p0 >> 16, p1, p0 & 0xFFFF], dim=-3)
    if bpp16:
        x = x << 3
    if flip_vertical:
        x = _flip_rows(x, -2)
    x = _normalize(x, dtype, scale / denom, mean)
    if layout == "NHWC":
        x = x.movedim(-3, -1)
    return x


def ds2_pack_ref(frame: torch.Tensor, flip: bool = False) -> torch.Tensor:
    """Plain twin of the ds2 kernel: [..., Y, X] u32 → [..., Y//2, X//2]
    i32 packed 10-bit field sums (b | g<<10 | r<<20); `flip` reverses the
    output rows."""
    c = frame
    f = ((c & 0xFF) | (((c >> 8) & 0xFF) << 10)
         | (((c >> 16) & 0xFF) << 20))
    red = _box2(f)
    return _flip_rows(red, -2) if flip else red


def ds2_pack(frame: torch.Tensor, flip: bool = False) -> torch.Tensor:
    """[..., Y, X] u32 → [..., Y//2, X//2] i32 packed field sums, rows
    reversed when `flip`.  CUDA kernel (csrc/ds2_pack.cu) for a tensor on
    the card; the plain twin only for a tensor on the CPU."""
    if frame.device.type == "cpu":
        return ds2_pack_ref(frame, flip=flip)
    cuda_launch_checks("ds2_pack", frame)
    Y, X = frame.shape[-2:]
    lead = frame.shape[:-2]
    fr = frame.reshape((-1, Y, X))
    if fr.stride(-1) != 1 or fr.stride(-2) != X:
        raise ValueError("ds2_pack needs row-contiguous [.., Y, X] frames")
    C = fr.shape[0]
    Ho, Wo = Y // 2, X // 2
    out = torch.empty((C, Ho, Wo), dtype=torch.int32, device=frame.device)
    if C and Ho and Wo:
        lib = _build.load()
        with torch.cuda.device(frame.device):
            rc = lib.jsp_ds2_pack(
                fr.data_ptr(), fr.stride(0), out.data_ptr(), out.stride(0),
                C, Y, X, int(bool(flip)),
                torch.cuda.current_stream(frame.device).cuda_stream)
        _build.check(rc, "ds2_pack")
        ds2_pack.launches += 1
    return out.reshape(lead + (Ho, Wo))


ds2_pack.launches = 0  # kernel launches (the plain path does not count)


def ds2_packed_output(frames: torch.Tensor, flip_vertical: bool = True
                      ) -> torch.Tensor:
    """The packed-ds2 model product: [.., H/2, W/2] i32 field-sum planes
    with the vertical flip already applied (folded into the kernel)."""
    return ds2_pack(frames, flip=flip_vertical)


def unpack_ds2(
    red: torch.Tensor,
    dtype=torch.bfloat16,
    layout: str = "NHWC",
    mean: float = 0.0,
    scale: float = 1.0 / 255.0,
    flip_vertical: bool = True,
    bpp16: bool = False,
) -> torch.Tensor:
    """Packed ds2 plane stack → normalized model tensors (the math of
    to_model_input(downscale=2), bit-exact)."""
    x = torch.stack([(red >> 20) & 1023, (red >> 10) & 1023, red & 1023],
                    dim=-3)
    if bpp16:
        x = x << 3
    if flip_vertical:
        x = _flip_rows(x, -2)
    x = _normalize(x, dtype, scale / 4.0, mean)
    if layout == "NHWC":
        x = x.movedim(-3, -1)
    return x

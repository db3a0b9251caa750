"""ML-ingestion model epilogue: u32 frames → normalized model tensors.

Counterpart of jsplayer_tpu/kernels/rgb_convert.py, with the same layouts
and argument names at the public functions.  Frames are int32 tensors
holding u32 bits (see device.py); `dtype` is a torch dtype.

``ds2_pack`` is the CUDA kernel csrc/ds2_pack.cu for tensors on the card
and its plain twin ``ds2_pack_ref`` for tensors on the CPU.  Everything
else here is plain torch, as it was XLA (not Pallas) in the JAX package:
the Manager's per-pixel colour repacks (Manager.hx:325-390), the channel
split, ``resize_half`` and the packed-ds2 consumer's patch-embed matrix
product.  ``to_model_input(downscale=2)`` routes through ``ds2_pack`` +
``unpack_ds2``: integer sums then one f32 multiply, bit-exact against the
unfused epilogue.
"""

from __future__ import annotations

import torch

from .. import _build
from ..device import cuda_launch_checks


#: 0xFF000000, the opaque alpha byte, as the int32 of the same bits
_ALPHA = -(1 << 24)


def rgb15_to_argb(frame: torch.Tensor) -> torch.Tensor:
    """16bpp ScreenPressor output → ARGB u32 bits (Manager.hx:363-370)."""
    return _ALPHA | (frame << 3)


def rgb_to_abgr(frame: torch.Tensor) -> torch.Tensor:
    """Packed (b<<16)|(g<<8)|r → 0xFF000000|(r<<16)|(g<<8)|b
    (Manager.hx:371-381)."""
    c = frame
    return _ALPHA | ((c & 0xFF) << 16) | (c & 0xFF00) | ((c >> 16) & 0xFF)


def rgb15_to_argb_conv_buffer(frame: torch.Tensor) -> torch.Tensor:
    """The conversion-buffer 16bpp path (`conv_buffer[i] = src[i] << 11`,
    Manager.hx:337-343)."""
    return frame << 11


def rgb_to_opaque(frame: torch.Tensor) -> torch.Tensor:
    """`conv_buffer[i] = 0xFF000000 | c` (Manager.hx:345-355)."""
    return _ALPHA | frame


def split_channels(frame: torch.Tensor, bpp16: bool = False
                   ) -> torch.Tensor:
    """u32 bits [..., H, W] → [..., H, W, 3] uint8 in true (R, G, B): the
    u32's high byte is displayed red and its low byte blue, for both codecs
    (the reference's canvas swizzle, Manager.hx:377-380).  For 16bpp SP
    content the 5-bit values are scaled <<3 like the display path (uint8
    arithmetic: the shift wraps as the JAX package's does)."""
    c = frame
    r = ((c >> 16) & 0xFF).to(torch.uint8)
    g = ((c >> 8) & 0xFF).to(torch.uint8)
    b = (c & 0xFF).to(torch.uint8)
    out = torch.stack([r, g, b], dim=-1)
    if bpp16:
        out = out << 3
    return out


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


def patch_embed(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A ViT patch-embed conv, stride equal to the patch, VALID (a
    remainder row or column of patches is dropped): x [N, H, W, C] NHWC,
    w [ph, pw, C, D] HWIO → [N, H // ph, W // pw, D] in x's dtype.

    Computed as one matrix product: the patches gathered into rows of
    ph*pw*C values in w's (ph, pw, C) order, times w as a [ph*pw*C, D]
    matrix (the JAX package's conv_general_dilated with
    dimension_numbers ("NHWC", "HWIO", "NHWC"))."""
    ph, pw, C, D = w.shape
    N, H, W = x.shape[0], x.shape[1] // ph, x.shape[2] // pw
    p = x[:, : H * ph, : W * pw].reshape(N, H, ph, W, pw, C)
    p = p.permute(0, 1, 3, 2, 4, 5).reshape(N * H * W, ph * pw * C)
    return (p @ w.to(x.dtype).reshape(ph * pw * C, D)).reshape(N, H, W, D)


def packed_consumer_step(red: torch.Tensor, w: torch.Tensor,
                         **unpack_kw) -> torch.Tensor:
    """The consuming side of the packed-ds2 contract: a ViT-style
    patch-embed conv whose first op takes unpack_ds2's output.

    red: [N, H, W] i32 packed planes (ds2_packed_output contract — flip
    already applied).  w: [ph, pw, 3, D] patch-embed weights.  Returns
    [N, H', W', D] embeddings in the unpack's dtype (bf16 default)."""
    unpack_kw.setdefault("flip_vertical", False)
    x = unpack_ds2(red, **unpack_kw)            # [N, H, W, 3]
    return patch_embed(x, w)


def resize_half(frame_u8: torch.Tensor) -> torch.Tensor:
    """2x box downsample on [..., H, W, C] uint8 (ingestion resize): the
    int32 2x2 sums over H and W (an odd last row or column dropped), // 4,
    back to uint8."""
    x = frame_u8.to(torch.int32).movedim(-1, 0)
    return (_box2(x) // 4).movedim(0, -1).to(torch.uint8)

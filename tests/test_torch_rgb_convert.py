"""The port's model epilogue (jsplayer_tpu_torch.kernels.rgb_convert) against
the JAX package's, bit for bit, on the CPU.

The ds2 pack is held against the Pallas kernel itself (run with
``interpret=True``) and against its XLA reference ``ds2_pack_ref``; the
unpack and to_model_input against the JAX functions.  u32 planes compare
through int32 views, bf16 tensors through int16 views.  Inputs come from
numpy with a fixed seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jsplayer_tpu.kernels import rgb_convert as J
from jsplayer_tpu_torch.kernels import rgb_convert as P

torch.set_num_threads(1)

DTYPES = {"bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float32": (jnp.float32, torch.float32)}


def frames_u32(shape, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)


def t32(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def bits(x):
    """JAX array or torch tensor → a numpy array of comparable bits."""
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x)
    if a.dtype == jnp.bfloat16:
        return a.view(np.int16)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def pallas_ds2(frames):
    """The TPU kernel _ds2_pack_kernel, launched as ds2_pack launches it but
    in interpret mode (it needs X even, X >= 256, Y >= 16)."""
    from jax.experimental import pallas as pl

    C, Y, X = frames.shape
    return np.asarray(pl.pallas_call(
        J._ds2_pack_kernel,
        grid=(C, -(-Y // J._DS2_BH)),
        in_specs=[pl.BlockSpec((1, J._DS2_BH, X), lambda t, i: (t, i, 0))],
        out_specs=pl.BlockSpec((1, J._DS2_BH // 2, X // 2),
                               lambda t, i: (t, i, 0)),
        out_shape=jax.ShapeDtypeStruct((C, Y // 2, X // 2), jnp.int32),
        interpret=True,
    )(jnp.asarray(frames)))


@pytest.mark.parametrize("flip", [False, True])
def test_ds2_pack_matches_pallas_kernel(flip):
    f = frames_u32((2, 256, 256), seed=1)
    want = pallas_ds2(f)
    if flip:
        want = want[:, ::-1]
    got = P.ds2_pack(t32(f), flip=flip)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(2, 16, 16), (3, 7, 9), (1, 5, 4),
                                   (2, 3, 2), (1, 1, 6), (4, 2, 33),
                                   (2, 1, 9, 11)])
@pytest.mark.parametrize("flip", [False, True])
def test_ds2_pack_matches_reference_odd_shapes(shape, flip):
    f = frames_u32(shape, seed=sum(shape))
    want = np.asarray(J.ds2_pack_ref(jnp.asarray(f)))
    if flip:
        want = want[..., ::-1, :]
    got = P.ds2_pack(t32(f), flip=flip)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("flip", [False, True])
def test_ds2_packed_output(flip):
    f = frames_u32((3, 12, 20), seed=3)
    want = J.ds2_packed_output(jnp.asarray(f), flip_vertical=flip)
    got = P.ds2_packed_output(t32(f), flip_vertical=flip)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("layout", ["NHWC", "NCHW"])
@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("bpp16", [False, True])
def test_unpack_ds2(dtype, layout, flip, bpp16):
    red = np.array(J.ds2_pack_ref(jnp.asarray(frames_u32((2, 3, 14, 22)))))
    jd, td = DTYPES[dtype]
    kw = dict(layout=layout, flip_vertical=flip, bpp16=bpp16, mean=0.485,
              scale=0.0173)
    want = J.unpack_ds2(jnp.asarray(red), dtype=jd, **kw)
    got = P.unpack_ds2(torch.from_numpy(red), dtype=td, **kw)
    assert got.dtype == td and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(bits(got), bits(want))


@pytest.mark.parametrize("downscale", [1, 2, 4])
@pytest.mark.parametrize("layout", ["NHWC", "NCHW"])
@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("bpp16", [False, True])
def test_to_model_input(downscale, layout, flip, bpp16):
    f = frames_u32((2, 3, 18, 26), seed=downscale)
    kw = dict(layout=layout, flip_vertical=flip, bpp16=bpp16,
              downscale=downscale)
    want = J.to_model_input(jnp.asarray(f), **kw)
    got = P.to_model_input(t32(f), **kw)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(bits(got), bits(want))


def test_to_model_input_float32_mean_scale():
    f = frames_u32((3, 16, 16), seed=9)
    kw = dict(mean=0.5, scale=0.02, downscale=4, layout="NCHW")
    want = J.to_model_input(jnp.asarray(f), dtype=jnp.float32, **kw)
    got = P.to_model_input(t32(f), dtype=torch.float32, **kw)
    np.testing.assert_array_equal(bits(got), bits(want))


def test_ds2_route_is_bit_exact_against_unfused_epilogue():
    """to_model_input(downscale=2) routes through ds2_pack + unpack_ds2;
    the reference's unfused reduce_window epilogue is the oracle
    (rgb_convert.unpack_ds2's bit-exactness claim)."""
    f = frames_u32((4, 20, 30), seed=11)
    for bpp16 in (False, True):
        want = J.to_model_input(jnp.asarray(f), downscale=2, bpp16=bpp16)
        fused = P.unpack_ds2(P.ds2_pack(t32(f)), bpp16=bpp16)
        np.testing.assert_array_equal(bits(fused), bits(want))
        np.testing.assert_array_equal(
            bits(P.to_model_input(t32(f), downscale=2, bpp16=bpp16)),
            bits(want))


def test_to_model_input_rejects_bad_downscale():
    with pytest.raises(ValueError):
        P.to_model_input(t32(frames_u32((8, 8))), downscale=3)


def test_flip_rows():
    x = torch.arange(24).reshape(2, 3, 4)
    want = np.asarray(J._flip_rows(jnp.arange(24).reshape(2, 3, 4), -2))
    np.testing.assert_array_equal(P._flip_rows(x, -2).numpy(), want)


# ---------------------------------------------------------------------------
# the Manager's colour repacks, the channel split and resize_half

ELEMENT_OPS = ["rgb15_to_argb", "rgb_to_abgr", "rgb15_to_argb_conv_buffer",
               "rgb_to_opaque"]


@pytest.mark.parametrize("name", ELEMENT_OPS)
@pytest.mark.parametrize("bits15", [False, True])
def test_element_op_matches_reference(name, bits15):
    """Every u32 input (bit 31 set included: 0xFF000000 is negative as an
    int32, and the right shifts are masked) gives the JAX op's bits."""
    f = frames_u32((3, 9, 13), seed=len(name) + bits15)
    if bits15:
        f &= 0x7FFF
    want = getattr(J, name)(jnp.asarray(f))
    got = getattr(P, name)(t32(f))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), bits(want))


@pytest.mark.parametrize("bpp16", [False, True])
def test_split_channels_matches_reference(bpp16):
    f = frames_u32((2, 7, 11), seed=5)
    want = np.asarray(J.split_channels(jnp.asarray(f), bpp16=bpp16))
    got = P.split_channels(t32(f), bpp16=bpp16)
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(4, 4, 3), (7, 9, 3), (2, 6, 10, 4),
                                   (1, 1, 3), (3, 5, 8, 1)])
def test_resize_half_matches_reference(shape):
    rng = np.random.default_rng(sum(shape))
    x = rng.integers(0, 256, shape, dtype=np.uint8)
    want = np.asarray(J.resize_half(jnp.asarray(x)))
    got = P.resize_half(torch.from_numpy(x))
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# packed_consumer_step: unpack_ds2 + a stride-patch conv
#
# Bit-exact within the port: the step over the packed planes equals the same
# patch-embed over to_model_input(downscale=2) (the reference's own contract,
# tests/test_rgb_convert.py).  Against JAX the unpacked inputs are equal bit
# for bit, but the conv sums ph*pw*3 products in its own order: XLA's
# convolution and torch's matrix product each accumulate in f32 and round
# once to the output dtype, so two f32 sums that differ in their last bits
# can round to bf16 values one ulp apart, two where the sum sits near a
# rounding boundary of both.  2 bf16 ulps is a relative 2**-7; atol covers
# sums near zero.  The float32 variant rounds nothing but the sum itself.

TOL = {"bfloat16": dict(rtol=2 ** -7, atol=1e-3),
       "float32": dict(rtol=1e-5, atol=1e-6)}


def patch_weights(ph, pw, D, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(0, 0.05, (ph, pw, 3, D)).astype(np.float32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape,patch", [((3, 32, 64), 8), ((2, 40, 56), 16),
                                         ((1, 18, 30), 4), ((4, 16, 16), 2)])
def test_packed_consumer_step_matches_reference(dtype, shape, patch):
    jd, td = DTYPES[dtype]
    C, Y2, X2 = shape
    f = frames_u32((C, 2 * Y2, 2 * X2), seed=patch) & 0xFFFFFF
    red = np.array(J.ds2_packed_output(jnp.asarray(f)))
    w = patch_weights(patch, patch, 16, seed=C)
    want = J.packed_consumer_step(jnp.asarray(red), jnp.asarray(w, jd),
                                  dtype=jd)
    got = P.packed_consumer_step(torch.from_numpy(red),
                                 torch.from_numpy(w).to(td), dtype=td)
    assert got.dtype == td and tuple(got.shape) == want.shape == (
        C, Y2 // patch, X2 // patch, 16)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])
    # within the port: the same patch-embed over the unfused epilogue
    dense = P.to_model_input(t32(f), downscale=2, dtype=td)
    np.testing.assert_array_equal(
        bits(got), bits(P.patch_embed(dense, torch.from_numpy(w).to(td))))


def test_packed_consumer_step_through_pipelines():
    """IngestConfig(model_packed=True) windows of both pipelines feed each
    package's packed_consumer_step: the packed planes are equal bit for
    bit, the embeddings within the bf16 tolerance, and the port's equal
    its own patch-embed over the unpacked pipeline's tensors."""
    from jsplayer_tpu.core.source import MemorySource as JMem
    from jsplayer_tpu.pipeline.ingest import IngestConfig as JCfg
    from jsplayer_tpu.pipeline.ingest import VideoIngestPipeline as JPipe
    from jsplayer_tpu_torch.core.source import MemorySource as PMem
    from jsplayer_tpu_torch.pipeline.ingest import IngestConfig as PCfg
    from jsplayer_tpu_torch.pipeline.ingest import \
        VideoIngestPipeline as PPipe
    from test_torch_host_copies import av_avi

    avi = av_avi()  # SP v4 32x32, 6 frames
    w = patch_weights(4, 4, 8, seed=11)
    jw, tw = jnp.asarray(w, jnp.bfloat16), torch.from_numpy(w).to(
        torch.bfloat16)
    kw = dict(window=6, emit_frames=False, model_downscale=2)
    (jb,) = list(JPipe([JMem(avi)], JCfg(model_packed=True, **kw)))
    (pb,) = list(PPipe([PMem(avi)], PCfg(model_packed=True, device="cpu",
                                         **kw)))
    (pu,) = list(PPipe([PMem(avi)], PCfg(device="cpu", **kw)))
    jred, pred = jb["model_input"], pb["model_input"]
    np.testing.assert_array_equal(pred.numpy(), np.asarray(jred))
    jred = jred.reshape((-1,) + jred.shape[2:])
    pred = pred.reshape((-1,) + tuple(pred.shape[2:]))
    got = P.packed_consumer_step(pred, tw)
    want = J.packed_consumer_step(jred, jw)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               **TOL["bfloat16"])
    dense = pu["model_input"]
    dense = dense.reshape((-1,) + tuple(dense.shape[2:]))
    np.testing.assert_array_equal(bits(got), bits(P.patch_embed(dense, tw)))

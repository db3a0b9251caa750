"""The port's CUDA kernels against their plain twins, on the card.

Marked ``cuda``: they skip where torch.cuda.is_available() is False (as on
a CPU-only test host) and run on a GPU machine with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(--noconftest: tests/conftest.py imports jax, which the GPU machine
need not have; nothing here imports it.)

The kernels build from jsplayer_tpu_torch/csrc/ at first use."""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def rand_u32(shape, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(a.view(np.int32))


@pytest.mark.parametrize("shape", [(1, 2, 2), (3, 7, 9), (2, 33, 130),
                                   (4, 1080, 1920)])
@pytest.mark.parametrize("flip", [False, True])
def test_ds2_pack_kernel(dev, shape, flip):
    from jsplayer_tpu_torch.kernels.rgb_convert import ds2_pack, ds2_pack_ref

    f = rand_u32(shape, seed=sum(shape)).to(dev)
    before = ds2_pack.launches
    got = ds2_pack(f, flip=flip)
    assert ds2_pack.launches == before + 1
    torch.testing.assert_close(got, ds2_pack_ref(f, flip=flip), rtol=0,
                               atol=0)


@pytest.mark.parametrize("B,K", [(1, 1), (4, 2), (3, 8)])
def test_kmv_compose_kernel(dev, B, K):
    from jsplayer_tpu_torch.kernels.sp_recon import kmv_compose, kmv_compose_ref

    Y, X = 48, 80
    rng = np.random.default_rng(B * 10 + K)
    prev = rand_u32((B, Y, X), seed=K).to(dev)
    word = (rng.integers(0, 1 << 24, (B, Y, X), dtype=np.uint32)
            | (rng.integers(0, 4, (B, Y, X), dtype=np.uint32) << 24)
            | (rng.integers(0, 8, (B, Y, X), dtype=np.uint32) << 26))
    pc = torch.from_numpy(word.view(np.int32)).to(dev)
    mvk = torch.from_numpy(
        rng.integers(-3 * X, 3 * X, (B, K, 2)).astype(np.int32)).to(dev)
    chg = torch.from_numpy(np.arange(B) % 3 != 1).to(dev)
    torch.testing.assert_close(kmv_compose(prev, pc, mvk, chg),
                               kmv_compose_ref(prev, pc, mvk, chg),
                               rtol=0, atol=0)


def test_kmv_compose_rejects_aliased_out(dev):
    from jsplayer_tpu_torch.kernels.sp_recon import kmv_compose

    prev = torch.zeros((2, 16, 16), dtype=torch.int32, device=dev)
    mvk = torch.zeros((2, 2, 2), dtype=torch.int32, device=dev)
    chg = torch.ones(2, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="alias"):
        kmv_compose(prev, prev.clone(), mvk, chg, out=prev)


def stills_avi(seed, nframes=12, X=48, Y=32):
    """A keyframe, then mostly stills with sparse paints and scrolls."""
    from jsplayer_tpu.encode.avi_mux import mux_avi
    from jsplayer_tpu.encode.sp_enc import ScreenPressorEncoder, pack_rgb

    rng = np.random.default_rng(seed)
    enc = ScreenPressorEncoder(4, X, Y)
    f = np.full((Y, X), pack_rgb(seed, 50, 90), dtype=np.uint32)
    chunks = []
    for t in range(nframes):
        f = f.copy()
        if t % 3 == 1:
            f[2:, :] = f[:-2, :].copy()
        if t % 4 == 2:
            f[(t % 6) * 4:(t % 6) * 4 + 4, 4:24] = pack_rgb(
                *rng.integers(0, 256, 3))
        flat = f.reshape(-1)
        chunks.append(enc.encode_i(flat) if t in (0, 7) else
                      enc.encode_p(flat))
    return mux_avi(chunks, X, Y, 24, codec="SPV4",
                   keyflags=[t in (0, 7) for t in range(nframes)])


@pytest.mark.parametrize("emit_frames", [True, False])
def test_ingest_cuda_matches_cpu(dev, emit_frames):
    from jsplayer_tpu.core.source import MemorySource
    from jsplayer_tpu_torch.pipeline import ingest as P

    avis = [stills_avi(s) for s in (3, 7, 11)]
    kw = dict(window=5, still_elision=True, model_downscale=2,
              emit_frames=emit_frames)
    outs, stats = {}, {}
    for d in ("cpu", "cuda"):
        pipe = P.VideoIngestPipeline([MemorySource(a) for a in avis],
                                     P.IngestConfig(device=d, **kw))
        outs[d] = list(pipe)
        stats[d] = pipe.stats
    assert stats["cuda"] == stats["cpu"]
    assert stats["cpu"]["concat_windows"] and stats["cpu"]["padded_windows"]
    for a, b in zip(outs["cpu"], outs["cuda"]):
        assert a.keys() == b.keys()
        for k, v in a.items():
            if isinstance(v, torch.Tensor):
                assert torch.equal(v, b[k].cpu()), k
            else:
                np.testing.assert_array_equal(np.asarray(v), np.asarray(b[k]))

"""The port's MSVideo1 device stage (kernels/msv1_paint, plain twins on the
CPU) and MSV1 ingest against jsplayer_tpu's on the same inputs, bit for
bit: paint_frame, significant_changes, decode_sequence and decode_batch on
the opcode fuzzers' streams (8- and 16-bit, several seeds) and on
MSV1_CASES' commands (sel >= 8, btype > 1, init_valid both ways,
insignificant lines); then VideoIngestPipeline on MSV1 AVIs: 16-bit, 8-bit
palettized, with MP3 audio, streaming, frame_range, a quarantined stream
and model_downscale 2."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jsplayer_tpu.codecs.msvideo1 import palette_to_u32, parse_commands
from jsplayer_tpu.core.source import MemorySource
from jsplayer_tpu.encode.avi_mux import mux_avi
from jsplayer_tpu.encode.msv1_enc import (encode_frame_8, random_stream_8,
                                          random_stream_16)
from jsplayer_tpu.kernels import msv1_paint as J
from jsplayer_tpu_torch.kernels import msv1_paint as P
from test_ingest import msv1_avi
from test_torch_block_cases import t32
from test_torch_host_copies import plain
from test_torch_ingest import assert_windows_equal, compare, pipelines
from test_torch_msv1_cases import MSV1_CASES, case_inputs

torch.set_num_threads(1)

X, Y = 32, 24


def u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def fuzz_window(bits, seed, B=2, T=6):
    """tests/test_msv1.py's fuzzed opcode streams, parsed by the reference
    → (btype [B, T, NB], sel [B, T, NB, 16], colors [B, T, NB, 8], changes
    [B, T])."""
    rng = np.random.default_rng(seed)
    pal = (rng.integers(0, 2**32, 256, dtype=np.uint64).astype(np.uint32)
           if bits == 8 else None)
    nb = (X // 4) * (Y // 4)
    bt = np.zeros((B, T, nb), np.uint8)
    sel = np.zeros((B, T, nb, 16), np.uint8)
    col = np.zeros((B, T, nb, 8), np.uint32)
    chg = np.zeros((B, T), bool)
    for b in range(B):
        for t in range(T):
            src = (random_stream_16 if bits == 16 else random_stream_8)(
                rng, X, Y, t > 0)
            bt[b, t], sel[b, t], col[b, t], chg[b, t] = parse_commands(
                src, X, Y, pal=pal)
    return bt, sel, col, chg


def test_sel_to_plane_matches_reference():
    rng = np.random.default_rng(0)
    sel = rng.integers(0, 256, (2, 3, (X // 4) * (Y // 4), 16)).astype(
        np.uint8)
    want = J.sel_to_plane(sel, Y, X)
    np.testing.assert_array_equal(P.sel_to_plane(sel, Y, X), want)
    np.testing.assert_array_equal(
        P.sel_to_plane(torch.from_numpy(sel), Y, X).numpy(), want)


@pytest.mark.parametrize("bits", [16, 8])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_paint_and_significance_match_reference(bits, seed):
    """Each step: paint_frame_ref against paint_frame, and
    significant_changes_ref against significant_changes with and without
    a previous frame."""
    bt, sel, col, _ = fuzz_window(bits, seed, B=1)
    sel = J.sel_to_plane(sel, Y, X)
    prev = np.random.default_rng(seed).integers(0, 1 << 32, (Y, X),
                                                dtype=np.uint32)
    for t in range(bt.shape[1]):
        want = J.paint_frame(jnp.asarray(prev), jnp.asarray(bt[0, t]),
                             jnp.asarray(sel[0, t]), jnp.asarray(col[0, t]))
        got = P.paint_frame_ref(t32(prev), torch.from_numpy(bt[0, t]),
                                torch.from_numpy(sel[0, t]), t32(col[0, t]))
        np.testing.assert_array_equal(u32(got), np.asarray(want))
        for valid in (False, True):
            for ib, il in ((0, 0), (2, 8), (6, 23)):
                w = J.significant_changes(
                    want, jnp.asarray(prev), jnp.asarray(valid),
                    jnp.asarray(bt[0, t]), jnp.int32(ib), jnp.int32(il),
                    X // 4)
                g = P.significant_changes_ref(
                    got, t32(prev), valid, torch.from_numpy(bt[0, t]), ib,
                    il, X // 4)
                assert bool(g) == bool(w), (t, valid, ib, il)
        prev = np.asarray(want)


def reference_batch(init, valid, bt, sel, col, chg, ib, il, nbx):
    frames, sig = J.decode_batch(
        jnp.asarray(init), jnp.asarray(valid), jnp.asarray(bt),
        jnp.asarray(sel), jnp.asarray(col), jnp.asarray(chg), jnp.int32(ib),
        jnp.int32(il), nbx)
    return np.asarray(frames), np.asarray(sig)


def port_batch(init, valid, bt, sel, col, chg, ib, il, nbx):
    frames, sig = P.decode_batch(
        t32(init), torch.from_numpy(valid), torch.from_numpy(bt),
        torch.from_numpy(np.ascontiguousarray(sel)), t32(col),
        torch.from_numpy(chg), ib, il, nbx)
    return u32(frames), sig.numpy()


@pytest.mark.parametrize("bits", [16, 8])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decode_batch_and_sequence_match_reference(bits, seed):
    """Fuzzed streams through decode_batch (B=2, one stream's init valid)
    and decode_sequence (one stream, init invalid), insignificant lines 8
    as tests/test_msv1.py's parity test."""
    bt, sel, col, chg = fuzz_window(bits, seed)
    sel = J.sel_to_plane(sel, Y, X)
    init = np.random.default_rng(seed + 7).integers(
        0, 1 << 32, (2, Y, X), dtype=np.uint32)
    valid = np.array([False, True])
    args = (init, valid, bt, sel, col, chg, 2, 8, X // 4)
    for got, want in zip(port_batch(*args), reference_batch(*args)):
        np.testing.assert_array_equal(got, want)
    want_f, want_s = J.decode_sequence(
        jnp.asarray(init[0]), jnp.asarray(False), jnp.asarray(bt[0]),
        jnp.asarray(sel[0]), jnp.asarray(col[0]), jnp.asarray(chg[0]),
        jnp.int32(2), jnp.int32(8), X // 4)
    got_f, got_s = P.decode_sequence(
        t32(init[0]), False, torch.from_numpy(bt[0]),
        torch.from_numpy(np.ascontiguousarray(sel[0])), t32(col[0]),
        torch.from_numpy(chg[0]), 2, 8, X // 4)
    np.testing.assert_array_equal(u32(got_f), np.asarray(want_f))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


@pytest.mark.parametrize("name", sorted(MSV1_CASES))
def test_case_windows_match_reference(name):
    """MSV1_CASES' commands (btype up to 3, sel up to 255, colours with the
    top bit, init_valid both ways, insignificant lines) through
    decode_batch and _decode_sequence_novmap."""
    init, bt, sel, col, chg, valid, il = case_inputs(name)
    nbx = init.shape[2] // 4
    ib = (il + 3) >> 2
    args = (init, valid, bt, sel, col, chg, ib, il, nbx)
    for got, want in zip(port_batch(*args), reference_batch(*args)):
        np.testing.assert_array_equal(got, want)
    want = J._decode_sequence_novmap(
        jnp.asarray(init[-1]), jnp.asarray(valid[-1]), jnp.asarray(bt[-1]),
        jnp.asarray(sel[-1]), jnp.asarray(col[-1]), jnp.asarray(chg[-1]),
        jnp.int32(ib), jnp.int32(il), nbx)
    got = P._decode_sequence_novmap(
        t32(init[-1]), bool(valid[-1]), torch.from_numpy(bt[-1]),
        torch.from_numpy(sel[-1]), t32(col[-1]), torch.from_numpy(chg[-1]),
        ib, il, nbx)
    np.testing.assert_array_equal(u32(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


# -- ingest ---------------------------------------------------------------------

def msv1_8_avi(seed, X8=32, Y8=32, T=11, audio=False):
    """An 8-bit palettized MSV1 stream with its palette in the header and,
    with `audio`, two MP3 sound chunks (BASELINE config 2's shape)."""
    from jsplayer_tpu.encode.mp3_synth import make_frames

    rng = np.random.default_rng(seed)
    pal = bytes(b for i in range(256)
                for b in (i, (i * 3) & 0xFF, (i * 7 + seed) & 0xFF, 0))
    idx = np.full(Y8 * X8, 3 + seed, dtype=np.uint8)
    chunks, prev = [], None
    for t in range(T):
        idx = idx.copy()
        x0 = int(rng.integers(0, (X8 - 4) // 4)) * 4
        idx.reshape(Y8, X8)[8:12, x0:x0 + 4] = int(rng.integers(0, 256))
        chunks.append(encode_frame_8(idx, prev, X8, Y8))
        prev = idx
    kw = {}
    if audio:
        mp3, _, _ = make_frames(40)
        half = len(mp3) // 2
        kw["sound_chunks"] = [(1, mp3[:half]), (4, mp3[half:])]
    return mux_avi(chunks, X8, Y8, 8, codec="CRAM", palette=pal,
                   keyflags=[t == 0 for t in range(T)], **kw)


MSV16 = [msv1_avi(s)[0] for s in (1, 2, 3)]
MSV8 = [msv1_8_avi(s) for s in (1, 2)]


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("kw", [
    dict(window=4),
    dict(window=4, model_downscale=2),
    dict(window=4, model_downscale=2, model_packed=True),
    dict(window=4, emit_model_input=False, insignificant_lines=5),
    dict(window=3, streaming=True),
    dict(window=4, frame_range=(5, 9)),
    dict(window=5, still_elision=True),
], ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_msv1_16_ingest(native, kw, monkeypatch):
    """16-bit MSV1 windows equal the reference's on both host parsers; with
    still_elision the windows stay unsnapped and dense, as the
    reference's."""
    if not native:
        from test_torch_ingest import no_native

        no_native(monkeypatch)
    pp = compare(MSV16, **kw)
    assert pp._bpp16 is False


@pytest.mark.parametrize("kw", [
    dict(window=4),
    dict(window=4, model_downscale=2),
    dict(window=3, streaming=True),
], ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_msv1_8_palette_ingest_with_audio(kw):
    """8-bit palettized MSV1 with MP3 tracks: windows equal, and the audio
    tracks the reference's."""
    avis = [msv1_8_avi(s, audio=True) for s in (1, 2)]
    jp, pp = pipelines(avis, **kw)
    assert_windows_equal(list(jp), list(pp))
    assert plain(pp.audio_tracks) == plain(jp.audio_tracks)
    assert all(t is not None and t.sections for t in pp.audio_tracks)


def test_msv1_8_palette_ingest():
    pp = compare(MSV8, window=4, model_downscale=2)
    assert pp.info.bpp == 8


def test_msv1_bpp16_is_not_rescaled():
    """MSV1 16-bit resolves to 8-bit channels at parse: its model tensors
    are not scaled by 8 a second time (the port's ScreenPressor-only
    _bpp16)."""
    pp = compare(MSV16[:1], window=4, model_downscale=2)
    assert pp.info.bpp == 16 and not pp._bpp16


def test_msv1_quarantined_stream():
    """A parse failure freezes its stream at the last good frame (the
    reference's tests/test_ingest.py injection at the guard)."""
    jp, pp = pipelines(MSV16[:2], window=4)
    for p in (jp, pp):
        calls, orig = [0], p._guard

        def poisoned(b, fn, *a, _orig=orig, _calls=calls, **k):
            if b == 1:
                _calls[0] += 1
                if _calls[0] >= 6:
                    def raiser():
                        raise ValueError("injected parse failure")
                    return _orig(b, raiser, **k)
            return _orig(b, fn, *a, **k)

        p._guard = poisoned
    assert_windows_equal(list(jp), list(pp))
    assert pp.quarantined == jp.quarantined == {1}


def test_msv1_keyframe_probe_and_range_start():
    """frame_range on MSV1 rewinds with the MSV1 decoders' is_key_frame (a
    ScreenPressor prober reads MSV1 bytes as something else)."""
    pp = compare(MSV16[:2], window=3, frame_range=(4, 8))
    assert type(pp._keyframe_prober()).__name__ == "MSVideo1_16bit"
    _, p8 = pipelines(MSV8[:1], window=3)
    assert type(p8._keyframe_prober()).__name__ == "MSVideo1_8bit"

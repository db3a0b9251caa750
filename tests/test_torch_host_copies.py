"""The port's copy of the host stage against its original in jsplayer_tpu.

jsplayer_tpu_torch imports nothing of jsplayer_tpu: it carries copies of the
host modules it runs (demux, the ScreenPressor codecs, the native decoder and
encoder, the encoders, GOP window snapping) at the same relative paths.
Each copy is held against its original here, on the CPU: same outputs on
the same inputs, and a text check that the copy differs from the original
only in import lines and the repairs listed in REPAIRS."""

import ctypes
import dataclasses
import difflib
import enum
import inspect
import os
import re
import threading
import time

import numpy as np
import pytest
import torch

import jsplayer_tpu_torch as PT
from jsplayer_tpu import native as JN
from jsplayer_tpu.codecs.screenpressor import ScreenPressor as JSP
from jsplayer_tpu.core.source import MemorySource as JMem
from jsplayer_tpu.encode.avi_mux import mux_avi as j_mux
from jsplayer_tpu.encode.mp3_synth import make_frames
from jsplayer_tpu.encode.sp_enc import ScreenPressorEncoder as JEnc
from jsplayer_tpu.kernels import lane_transport as JLT
from jsplayer_tpu.pipeline.gop import snap_window_starts as j_snap
from jsplayer_tpu.pipeline.ingest import StreamReader as JReader
from jsplayer_tpu.utils.corpora import screen_mix as j_mix
from jsplayer_tpu_torch import native as PN
from jsplayer_tpu_torch.codecs.screenpressor import ScreenPressor as PSP
from jsplayer_tpu_torch.core.source import MemorySource as PMem
from jsplayer_tpu_torch.encode.avi_mux import mux_avi as p_mux
from jsplayer_tpu_torch.encode.sp_enc import ScreenPressorEncoder as PEnc
from jsplayer_tpu_torch.encode.sp_enc import pack_rgb
from jsplayer_tpu_torch.kernels import lane_transport as PLT
from jsplayer_tpu_torch.pipeline.gop import snap_window_starts as p_snap
from jsplayer_tpu_torch.pipeline.ingest import StreamReader as PReader
from jsplayer_tpu_torch.utils.corpora import screen_mix as p_mix
from test_ingest import msv1_avi, sp_avi, sp_avi_stills

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(ROOT, "jsplayer_tpu")
PORT = os.path.dirname(os.path.abspath(PT.__file__))

#: every copied file, by its path relative to both packages
COPIES = [
    "core/__init__.py", "core/source.py", "core/types.py",
    "core/chunkbuffer.py", "core/riff.py", "core/loader.py",
    "av/__init__.py", "av/audio_track.py", "av/mp3.py",
    "utils/__init__.py", "utils/logging.py", "utils/corpora.py",
    "codecs/__init__.py", "codecs/base.py", "codecs/screenpressor.py",
    "codecs/entropy.py", "codecs/rangecoder.py", "codecs/rans.py",
    "pipeline/gop.py", "native/__init__.py", "native/spdec.cpp",
    "encode/__init__.py", "encode/sp_enc.py", "encode/avi_mux.py",
    "codecs/msvideo1.py", "codecs/lane_format.py", "transcode.py",
    "encode/msv1_enc.py", "encode/mp3_synth.py",
]

#: the repairs a copy may carry beyond its import lines: for each file,
#: the regions (a regex for the first line, a regex for the line after the
#: region, or None for the end of the file) in which the two texts may
#: differ, with what the region repairs
REPAIRS = {
    # the library builds with g++ into build/libjsptpu_host.so, not with
    # make into the package; load() takes a lock (reference fault 3)
    "native/__init__.py": [(r'^"""ctypes bindings', r"^    _tried = True$")],
    # device_trace used jax.profiler; nothing of the port calls it
    "utils/logging.py": [(r"^TPU-era extensions", r'^"""$'),
                         (r"^LOG = Log\(\)", None)],
    # derive_window reads `restart` from the derived commands, the parser's
    # own test (ROADMAP §3 reference host fault 1): the command derivation
    # moves ahead of the restart test
    "codecs/lane_format.py": [(r"^    btype = np\.zeros\(\(T, NB\)",
                               r"^        if not changed\[t\]:")],
}

IMPORT_LINE = re.compile(r"^\s*(from\s+\S+\s+import\b|import\s+\S)")


def _cut_regions(lines, regions):
    """lines with each repair region replaced by one marker line."""
    out, i = [], 0
    for first, after in regions:
        start = next(j for j in range(i, len(lines))
                     if re.match(first, lines[j]))
        end = len(lines) if after is None else next(
            j for j in range(start + 1, len(lines))
            if re.match(after, lines[j]))
        out += lines[i:start] + [f"<repair {first}>"]
        i = end
    return out + lines[i:]


@pytest.mark.parametrize("rel", COPIES)
def test_copy_differs_only_in_imports_and_repairs(rel):
    with open(os.path.join(REF, rel)) as f:
        ref = f.read().splitlines()
    with open(os.path.join(PORT, rel)) as f:
        port = f.read().splitlines()
    regions = REPAIRS.get(rel, [])
    ref, port = _cut_regions(ref, regions), _cut_regions(port, regions)
    changed = [line for line in difflib.unified_diff(ref, port, lineterm="",
                                                     n=0)
               if line[:1] in "+-" and line[:3] not in ("+++", "---")]
    bad = [line for line in changed if not IMPORT_LINE.match(line[1:])]
    assert not bad, "\n".join(bad)


def test_every_host_module_of_the_port_is_a_listed_copy():
    """Each module the port keeps in the copied subpackages is in COPIES
    (so none escapes the text check)."""
    found = []
    for sub in ("core", "av", "utils", "codecs", "native", "encode"):
        for name in os.listdir(os.path.join(PORT, sub)):
            if name.endswith((".py", ".cpp")):
                found.append(f"{sub}/{name}")
    assert sorted(found + ["pipeline/gop.py", "transcode.py"]) == \
        sorted(COPIES)


# ---------------------------------------------------------------------------
# demux

def plain(v):
    """A value of either package → plain data (dataclasses, enums and
    objects by their fields) for comparison across the two class trees."""
    if isinstance(v, enum.Enum):
        return v.value
    if dataclasses.is_dataclass(v):
        return {f.name: plain(getattr(v, f.name))
                for f in dataclasses.fields(v)}
    if isinstance(v, (list, tuple)):
        return [plain(x) for x in v]
    if isinstance(v, dict):
        return {k: plain(x) for k, x in v.items()}
    if isinstance(v, np.ndarray):
        return v.tolist()
    if hasattr(v, "__dict__") and not callable(v):
        return {k: plain(x) for k, x in vars(v).items()}
    return v


def av_avi():
    """An SP v4 stream with two MP3 sound chunks (the A/V fixture of
    tests/test_ingest.py)."""
    enc = JEnc(4, 32, 32)
    f = np.full(32 * 32, pack_rgb(5, 5, 5), dtype=np.uint32)
    chunks = [enc.encode_i(f)]
    for t in range(5):
        f = f.copy()
        f[64 + t * 32: 96 + t * 32] = pack_rgb(t + 1, 9, 9)
        chunks.append(enc.encode_p(f))
    mp3, _, _ = make_frames(40)
    half = len(mp3) // 2
    return j_mux(chunks, 32, 32, 24, codec="SPV4",
                 keyflags=[t == 0 for t in range(6)],
                 sound_chunks=[(1, mp3[:half]), (3, mp3[half:])])


DEMUX_FIXTURES = {
    "sp": lambda: sp_avi(1)[0], "sp_stills": lambda: sp_avi_stills(7)[0],
    "msv1": lambda: msv1_avi(2)[0], "av": av_avi,
}


@pytest.mark.parametrize("streaming", [False, True])
@pytest.mark.parametrize("name", sorted(DEMUX_FIXTURES))
def test_demux_matches_reference(name, streaming):
    """VideoInfo, frame bytes, key flags and the audio track of the port's
    StreamReader (core/, av/, utils/logging copies) equal the
    reference's."""
    avi = DEMUX_FIXTURES[name]()
    j, p = JReader(JMem(avi), streaming), PReader(PMem(avi), streaming)
    if streaming:
        j.fetch_upto(1 << 20)
        p.fetch_upto(1 << 20)
    assert plain(p.info) == plain(j.info)
    assert plain(p.loader.frames) == plain(j.loader.frames)
    assert len(p.loader.frames) > 5
    assert plain(p.audio_track) == plain(j.audio_track)
    if name == "av":
        assert p.audio_track.time_loaded > 0


# ---------------------------------------------------------------------------
# codecs and encoders

def sp_frames(version, n=7, X=32, Y=32, seed=0):
    """Frames of a small screen stream: scrolls and paints."""
    rng = np.random.default_rng(seed + version)
    f = np.full((Y, X), pack_rgb(6, 6, 6), dtype=np.uint32)
    out = [f.reshape(-1)]
    for t in range(n - 1):
        f = f.copy()
        if t % 3 == 0:
            f[2:, :] = f[:-2, :].copy()
        elif t % 3 == 1:
            f[4:8, 8:24] = pack_rgb(*rng.integers(0, 256, 3))
        out.append(f.reshape(-1))
    return out


def encode(enc_cls, version, frames, keys=(0,)):
    enc = enc_cls(version, 32, 32)
    return [enc.encode_i(f) if t in keys else enc.encode_p(f)
            for t, f in enumerate(frames)]


@pytest.mark.parametrize("version", [2, 3, 4])
def test_encoder_and_mux_match_reference(version):
    frames = sp_frames(version)
    keys = (0, 4)
    got, want = encode(PEnc, version, frames, keys), \
        encode(JEnc, version, frames, keys)
    assert got == want
    kw = dict(codec=f"SPV{version}", keyflags=[t in keys for t in range(7)])
    assert p_mux(got, 32, 32, 24, **kw) == j_mux(want, 32, 32, 24, **kw)


@pytest.mark.parametrize("version", [2, 3, 4])
def test_oracle_decode_matches_reference(version):
    """The pure-Python ScreenPressor (codecs/ copies: range coder, rANS,
    entropy): is_key_frame and every decoded u32 frame."""
    chunks = encode(JEnc, version, sp_frames(version), keys=(0, 4))
    j, p = JSP(32, 32, 24), PSP(32, 32, 24)
    for src in chunks + [b""]:
        assert p.is_key_frame(src) == j.is_key_frame(src)
        outs = []
        for dec in (j, p):
            dst = np.zeros(32 * 32, dtype=np.uint32)
            if dec.is_key_frame(src):
                res = plain(dec.decompress_i(src, dst))
            else:
                res = plain(dec.decompress_p(src, dst))
            outs.append((res, dst, dec.previous_frame().copy()))
        assert outs[1][0] == outs[0][0]
        np.testing.assert_array_equal(outs[1][1], outs[0][1])
        np.testing.assert_array_equal(outs[1][2], outs[0][2])


@pytest.mark.parametrize("seed", [0, 3])
def test_screen_mix_matches_reference(seed):
    got = p_mix(T=6, Y=170, X=260, seed=seed)
    want = j_mix(T=6, Y=170, X=260, seed=seed)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("window", [1, 3, 4, 16])
@pytest.mark.parametrize("n_frames", [0, 1, 5, 17, 40])
def test_snap_window_starts_matches_reference(window, n_frames):
    for keys in ([], [0], [0, 5], [0, 3, 4, 9, 15, 30], list(range(0, 40, 7)),
                 [2, 11, 12, 13], [0, 39]):
        assert p_snap(keys, n_frames, window) == \
            j_snap(keys, n_frames, window), keys


# ---------------------------------------------------------------------------
# the native library

def test_native_library_is_the_ports_own():
    """The port builds spdec.cpp into build/ at the repository root and
    loads that library, apart from the reference's: their entry points
    resolve to different addresses."""
    assert PN.available() and JN.available()
    assert PN._LIB_PATH == os.path.join(ROOT, "build", "libjsptpu_host.so")
    assert os.path.exists(PN._LIB_PATH)
    assert not PN._LIB_PATH.startswith(REF + os.sep)
    for fn in ("sp_create", "sp_decompress_kmv2", "spenc_encode"):
        pa = ctypes.cast(getattr(PN.load(), fn), ctypes.c_void_p).value
        ja = ctypes.cast(getattr(JN.load(), fn), ctypes.c_void_p).value
        assert pa != ja, fn


def streams_of(n=3, version=4):
    return [encode(JEnc, version, sp_frames(version, seed=s), keys=(0, 4))
            for s in range(n)]


def test_native_decode_streams_kmv_matches_reference():
    streams = streams_of()
    for K in (1, 2, 4):
        got = PN.native_sp_decode_streams_kmv(streams, 32, 32, K=K)
        want = JN.native_sp_decode_streams_kmv(streams, 32, 32, K=K)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert want["changed"].sum() > 3


def test_native_decode_streams_capture_matches_reference():
    streams = streams_of()
    got = PN.native_sp_decode_streams(streams, 32, 32)
    want = JN.native_sp_decode_streams(streams, 32, 32)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_native_per_frame_decode_matches_reference():
    """decompress(capture=True) and decompress_kmv with dirty rows, the
    two per-frame calls of the port's ingest."""
    chunks = streams_of(1)[0] + [b""]
    j, p = JN.NativeScreenPressor(32, 32), PN.NativeScreenPressor(32, 32)
    for src in chunks:
        isk = j.is_key_frame(src)
        assert p.is_key_frame(src) == isk
        fj, sj, cj = j.decompress(src, isk, capture=True)
        fp, sp, cp = p.decompress(src, isk, capture=True)
        assert sp == sj and (fp is None) == (fj is None)
        if fj is not None:
            np.testing.assert_array_equal(fp, fj)
        assert plain(cp) == plain(cj)
    nb1 = 1 + 2 * 2
    j, p = JN.NativeScreenPressor(32, 32), PN.NativeScreenPressor(32, 32)
    bufs = {d: (np.zeros((32, 32), np.uint32), np.zeros((2, 2), np.int32),
                np.zeros(nb1, np.int32)) for d in ("j", "p")}
    for src in chunks:
        isk = j.is_key_frame(src)
        rj = j.decompress_kmv(src, isk, *bufs["j"][:2], K=2,
                              dirty=bufs["j"][2])
        rp = p.decompress_kmv(src, isk, *bufs["p"][:2], K=2,
                              dirty=bufs["p"][2])
        assert rp == rj
        for a, b in zip(bufs["p"], bufs["j"]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("version", [2, 3, 4])
def test_native_encoder_matches_reference(version):
    frames = sp_frames(version, n=6)
    outs = []
    for mod in (JN, PN):
        enc = mod.NativeScreenPressorEncoder(version, 32, 32)
        outs.append([enc.encode_i(frames[0])]
                    + [enc.encode_p(f) for f in frames[1:]]
                    + [enc.encode_flat(0x123456)])
    assert outs[1] == outs[0]
    # and the native encoder is byte-identical to the Python one
    assert outs[1][:-1] == encode(PEnc, version, frames)


def test_native_load_is_thread_safe(monkeypatch):
    """Eight threads call the port's load() at once while the first is
    still loading: every thread gets the same library (the lock repairs
    ROADMAP §3 reference fault 3)."""
    real = ctypes.CDLL

    def slow_cdll(*a, **kw):
        time.sleep(0.3)
        return real(*a, **kw)

    monkeypatch.setattr(PN, "_lib", None)
    monkeypatch.setattr(PN, "_tried", False)
    monkeypatch.setattr(ctypes, "CDLL", slow_cdll)
    got = [None] * 8
    start = threading.Barrier(8)

    def one(i):
        start.wait()
        got[i] = PN.load()

    threads = [threading.Thread(target=one, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    monkeypatch.setattr(ctypes, "CDLL", real)
    assert all(lib is not None for lib in got)
    assert len({id(lib) for lib in got}) == 1


# ---------------------------------------------------------------------------
# MSVideo1, the lane container and its transcoder

def msv1_8_avi(seed, X=64, Y=48, T=7):
    """An 8-bit palettized MSV1 stream (tests/test_lane_container.py's)."""
    from jsplayer_tpu.encode.msv1_enc import encode_frame_8

    rng = np.random.default_rng(seed)
    pal = bytes(b for i in range(256)
                for b in (i, (i * 3) & 0xFF, (i * 7) & 0xFF, 0))
    idx = np.full(Y * X, 3, dtype=np.uint8)
    chunks, prev = [], None
    for t in range(T):
        idx = idx.copy()
        x0 = int(rng.integers(0, (X - 4) // 4)) * 4
        idx.reshape(Y, X)[8:12, x0:x0 + 4] = int(rng.integers(0, 256))
        chunks.append(encode_frame_8(idx, prev, X, Y))
        prev = idx
    return j_mux(chunks, X, Y, 8, codec="CRAM", palette=pal,
                 keyflags=[t == 0 for t in range(T)])


def msv1_16_avi(seed):
    from test_lane_container import _msv1_16_avi

    return _msv1_16_avi(seed, 64, 48, 9)[0]


@pytest.mark.parametrize("bits", [8, 16])
def test_msvideo1_matches_reference(bits):
    """The port's MSVideo1 decoders and parse_commands on every frame of a
    stream: results, frames and command tensors equal the reference's."""
    from jsplayer_tpu.codecs import msvideo1 as JM
    from jsplayer_tpu_torch.codecs import msvideo1 as PM

    avi = msv1_8_avi(1) if bits == 8 else msv1_16_avi(1)
    r = JReader(JMem(avi))
    X, Y = r.info.width, r.info.height
    pal = r.info.palette or b""
    decs = [M.MSVideo1_8bit(X, Y, pal) if bits == 8 else M.MSVideo1_16bit(X, Y)
            for M in (JM, PM)]
    for d in decs:
        d.preinit(0)
    for src in r.frames + [b""]:
        outs = []
        for dec in decs:
            dst = np.zeros(X * Y, dtype=np.uint32)
            isk = dec.is_key_frame(src)
            res = dec.decompress_i(src, dst) if isk else \
                dec.decompress_p(src, dst)
            outs.append((isk, plain(res), dst, dec.previous_frame()))
        assert outs[1][:2] == outs[0][:2]
        np.testing.assert_array_equal(outs[1][2], outs[0][2])
        np.testing.assert_array_equal(outs[1][3], outs[0][3])
        p_pal = PM.palette_to_u32(pal) if bits == 8 else None
        j_pal = JM.palette_to_u32(pal) if bits == 8 else None
        for a, b in zip(PM.parse_commands(src, X, Y, p_pal),
                        JM.parse_commands(src, X, Y, j_pal)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def lane_sources():
    """name → AVI bytes: SP v2/v3/v4 (keyframes every 5 or one), MSV1 8
    and 16 bit."""
    from test_lane_container import make_avi

    return {"sp4_keys": lambda: make_avi(7, 64, 48, 14, key_every=5)[0],
            "sp4_one_key": lambda: make_avi(8, 64, 48, 10)[0],
            "sp2": lambda: make_avi(7, 64, 48, 8, version=2)[0],
            "sp3": lambda: make_avi(7, 64, 48, 8, version=3)[0],
            "msv1_8": lambda: msv1_8_avi(2),
            "msv1_16": lambda: msv1_16_avi(2)}


@pytest.mark.parametrize("payload", ["raw", "rans"])
@pytest.mark.parametrize("name", sorted(lane_sources()))
def test_transcode_to_lane_matches_reference(name, payload):
    """The port's transcode_to_lane (its copies of transcode.py,
    codecs/lane_format.py, codecs/msvideo1.py and rans_lanes' host helpers)
    writes the reference's container byte for byte, keyframe- and
    stride-aligned, deflated or not."""
    from jsplayer_tpu.transcode import transcode_to_lane as j_lane
    from jsplayer_tpu_torch.transcode import transcode_to_lane as p_lane

    avi = lane_sources()[name]()
    for kw in (dict(), dict(align="stride", compress=False)):
        want = j_lane(avi, window=4, K=2, payload=payload, **kw)
        assert p_lane(avi, window=4, K=2, payload=payload, **kw) == want, kw


@pytest.mark.parametrize("align", ["keyframes", "stride"])
def test_transcode_to_lane_jobs_matches_reference(align):
    """jobs > 1 (restart-delimited units in threads) gives the serial
    reference's bytes, both payloads; use_native=False (the pure-Python
    oracle) too."""
    from jsplayer_tpu.transcode import transcode_to_lane as j_lane
    from jsplayer_tpu_torch.transcode import transcode_to_lane as p_lane
    from test_lane_container import make_avi

    avi = make_avi(7, 64, 48, 24, key_every=5)[0]
    for payload in ("raw", "rans"):
        want = j_lane(avi, window=4, K=2, payload=payload, align=align)
        assert p_lane(avi, window=4, K=2, payload=payload, align=align,
                      jobs=4) == want
    assert p_lane(avi, window=4, K=2, align=align, use_native=False) == \
        j_lane(avi, window=4, K=2, align=align, use_native=False)


def test_lane_container_parse_matches_reference():
    """container_from_bytes of the port and the reference: equal fields on
    raw (sub-unit and plain), rans and audio-carrying containers."""
    from jsplayer_tpu.codecs import lane_format as JL
    from jsplayer_tpu.transcode import transcode_to_lane as j_lane
    from jsplayer_tpu_torch.codecs import lane_format as PL

    avi = lane_sources()["sp4_keys"]()
    for kw in (dict(), dict(compress=False), dict(payload="rans")):
        blob = j_lane(avi, window=4, K=2, **kw)
        assert PL.is_lane_container(blob)
        got, want = PL.container_from_bytes(blob), JL.container_from_bytes(blob)
        assert plain(got) == plain(want)
        ncol = PL.plane_cols(got.X) // 128
        for gw, ww in zip(got.windows, want.windows):
            for a, b in zip(gw.row_index(got.Y, ncol),
                            ww.row_index(want.Y, ncol)):
                np.testing.assert_array_equal(a, b)
        assert PL.container_to_bytes(got) == JL.container_to_bytes(want)


def malformed_containers():
    """tests/test_lane_container.py's malformed cases → [(what, bytes)]:
    truncations, a bad magic, an absurd T, a deflate bomb in the bulk, a
    bomb behind an empty bulk, an out-of-range sub-unit id, a record shrunk
    below its header, duplicated windows, and each window's restart flag
    flipped."""
    import struct
    import zlib

    from jsplayer_tpu.codecs import lane_format as JL
    from jsplayer_tpu.transcode import transcode_to_lane as j_lane
    from test_lane_container import make_avi

    hs = struct.calcsize("<4sHHBBHIHII")
    avi = make_avi(9, 48, 32, 4)[0]
    cont = j_lane(avi, window=4)
    out = [(f"cut {c}", cont[:c]) for c in (3, 10, len(cont) // 2,
                                            len(cont) - 5)]
    out.append(("magic", b"XXXX" + cont[4:]))
    bad = bytearray(cont)
    bad[hs + 4: hs + 6] = (60000).to_bytes(2, "little")
    out.append(("absurd T", bytes(bad)))
    c = JL.container_from_bytes(cont)
    w = c.windows[0]
    body = JL._window_to_bytes(w, c.K, c.n_lanes, compress=False)
    bulk_len = 3 * w.n_units * 128
    meta = bytearray(body[4: len(body) - bulk_len])
    meta[struct.calcsize("<HIII")] |= 4 | 2
    bomb = zlib.compress(b"\x00" * (bulk_len + 4096), 9)
    rec = bytes(meta) + struct.pack("<I", len(bomb)) + bomb
    out.append(("bulk bomb", cont[:hs] + struct.pack("<I", len(rec)) + rec))
    w.unit_rows = [np.zeros(0, dtype=np.int64) for _ in range(w.T)]
    w.unit_idx, w.n_units = None, 0
    w.payload = np.zeros((0, 3, 128), dtype=np.uint8)
    meta = bytearray(JL._window_to_bytes(w, c.K, c.n_lanes,
                                         compress=False)[4:])
    meta[struct.calcsize("<HIII")] |= 4
    bomb = zlib.compress(b"\x00" * (8 << 20), 9)
    rec = bytes(meta) + struct.pack("<I", len(bomb)) + bomb
    out.append(("empty bulk bomb",
                cont[:hs] + struct.pack("<I", len(rec)) + rec))
    wire = bytearray(j_lane(make_avi(5, 64, 48, 6)[0], window=6,
                            compress=False))
    wire[-2:] = b"\xff\xff"
    out.append(("sub-unit id", bytes(wire)))
    shrunk = bytearray(cont)
    shrunk[hs: hs + 4] = struct.pack("<I", 0)
    out.append(("record header", bytes(shrunk)))
    keyed = bytes(j_lane(make_avi(21, 48, 32, 14, key_every=5)[0], window=4,
                         K=2))
    (rec_len,) = struct.unpack_from("<I", keyed, hs)
    out.append(("tiling", keyed + keyed[hs: hs + 4 + rec_len]))
    c = JL.container_from_bytes(keyed)
    good = JL.container_to_bytes(c, compress=False)
    for wi, win in enumerate(c.windows):
        win.restart = not win.restart
        flipped = JL.container_to_bytes(c, compress=False)
        win.restart = not win.restart
        diff = [i for i in range(len(good)) if good[i] != flipped[i]]
        assert len(diff) == 1
        m = bytearray(good)
        m[diff[0]] = flipped[diff[0]]
        out.append((f"restart flag {wi}", bytes(m)))
    return out


def test_lane_container_rejects_what_the_reference_rejects():
    from jsplayer_tpu.codecs import lane_format as JL
    from jsplayer_tpu_torch.codecs import lane_format as PL

    cases = malformed_containers()
    assert len(cases) > 12
    for what, blob in cases:
        msgs = []
        for mod in (JL, PL):
            with pytest.raises(ValueError) as e:
                mod.container_from_bytes(blob)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1], what


def full_repaint_window():
    """A capture whose frame 0 repaints every 16x16 block with full-rect
    data blocks, a third of them bts 2 (not 1), then a paint and a still
    → (bts, mv, rect, frames, changed, signif, X, Y)."""
    from jsplayer_tpu.codecs.lane_format import block_full_rects

    X, Y, T = 48, 32, 3
    nbx, nby = X // 16, Y // 16
    rng = np.random.default_rng(4)
    frames = np.zeros((T, Y, X), dtype=np.uint32)
    frames[0] = rng.integers(0, 1 << 24, (Y, X), dtype=np.uint32)
    frames[1] = frames[0]
    frames[1, 3:9, 5:20] = 0x123456
    frames[2] = frames[1]
    bts = np.zeros((T, nbx * nby), dtype=np.int32)
    rect = np.zeros((T, nbx * nby, 4), dtype=np.int32)
    bts[0] = 1
    bts[0, ::3] = 2
    rect[0] = block_full_rects(X, Y, nbx, nby)
    bts[1, [0, 1]] = 1
    rect[1, 0] = (5, 3, 16, 9)
    rect[1, 1] = (16, 3, 20, 9)
    mv = np.zeros((T, nbx * nby, 2), dtype=np.int32)
    changed = np.array([True, True, False])
    return bts, mv, rect, frames, changed, changed.copy(), X, Y


@pytest.mark.parametrize("payload", ["raw", "rans"])
def test_lane_restart_from_derived_commands(payload):
    """Reference host fault 1, repaired in the port's copy: a frame-0 full
    repaint holding bts-2 full-rect data blocks derives restart=False in the
    reference (its raw bts[0] == 1 test), which its own parser then rejects;
    the port derives restart from the derived commands, the parser's test,
    and its container parses and decodes to the source frames.  On every
    other capture the two containers are the same bytes (pinned above)."""
    from jsplayer_tpu.codecs import lane_format as JL
    from jsplayer_tpu_torch.codecs import lane_format as PL
    from jsplayer_tpu_torch.kernels import lane_recon

    bts, mv, rect, frames, changed, signif, X, Y = full_repaint_window()

    def container(mod):
        w = mod.derive_window(bts, mv, rect, frames, changed, signif, X, Y,
                              2, 128, payload_mode=payload)
        c = mod.LaneContainer(X=X, Y=Y, bpp=24, K=2, n_lanes=128,
                              n_frames=len(frames), window=len(frames),
                              fps=10.0, windows=[w])
        return w, mod.container_to_bytes(c)

    jw, jblob = container(JL)
    assert not jw.restart
    with pytest.raises(ValueError, match="restart flag"):
        JL.container_from_bytes(jblob)
    pw, pblob = container(PL)
    assert pw.restart and (pw.init_plane is not None) == (payload == "rans")
    (w,) = PL.container_from_bytes(pblob).windows
    assert w.restart
    rt, ri = w.row_index(Y, PL.plane_cols(X) // 128)
    cmds = [torch.from_numpy(np.ascontiguousarray(a)) for a in (
        w.btype, w.rect, w.mvk, rt, ri, w.changed)]
    zero = torch.zeros((Y, X), dtype=torch.int32)
    if payload == "raw":
        got = lane_recon.decode_window_raw(
            zero, torch.from_numpy(w.payload), *cmds)
    else:
        got = lane_recon.decode_window_lane(
            torch.from_numpy(w.init_plane.view(np.int32)),
            torch.from_numpy(w.refills),
            torch.from_numpy(w.states.view(np.int32)),
            torch.from_numpy(w.freq), *cmds, U=w.n_units)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), frames)


@pytest.mark.parametrize("bits", [8, 16])
def test_msv1_encoder_matches_reference(bits):
    """The port's encode/msv1_enc.py: encode_frame_8/16 over a chain (a
    keyframe, then skips and 1-, 2- and 8-colour blocks) and the opcode
    fuzzers, byte for byte."""
    from jsplayer_tpu.encode import msv1_enc as JE
    from jsplayer_tpu.codecs.msvideo1 import from_rgb15
    from jsplayer_tpu_torch.encode import msv1_enc as PE

    X, Y = 48, 32
    rng = np.random.default_rng(bits)
    if bits == 16:
        pal = np.array([from_rgb15(int(c)) for c in
                        rng.integers(0, 0x8000, 9)], dtype=np.uint32)
    qy, qx = np.mgrid[0:Y, 0:X] // 2

    def encodable():  # at most two colours in each 2x2 quadrant
        pair = rng.integers(0, 9, (Y // 2, X // 2, 2))
        return pair[qy, qx, rng.integers(0, 2, (Y, X))]

    frame = encodable()
    prev, outs = None, ([], [])
    for t in range(6):
        frame, other = frame.copy(), encodable()
        for _ in range(4):
            by, bx = rng.integers(0, Y // 4) * 4, rng.integers(0, X // 4) * 4
            frame[by:by + 4, bx:bx + 4] = other[by:by + 4, bx:bx + 4]
        frame[:4, :4] = t  # a one-colour block
        cur = (pal[frame] if bits == 16 else frame.astype(np.uint8))
        for out, mod in zip(outs, (JE, PE)):
            enc = mod.encode_frame_16 if bits == 16 else mod.encode_frame_8
            out.append(enc(cur.reshape(-1), prev, X, Y))
        prev = cur.reshape(-1)
    assert outs[1] == outs[0] and len(set(outs[0])) > 1
    fuzz = "random_stream_16" if bits == 16 else "random_stream_8"
    for skip in (False, True):
        got = getattr(PE, fuzz)(np.random.default_rng(3), X, Y, skip)
        want = getattr(JE, fuzz)(np.random.default_rng(3), X, Y, skip)
        assert got == want
    assert PE.to_rgb15(0x123456) == JE.to_rgb15(0x123456)


def test_mp3_synth_matches_reference():
    """The port's encode/mp3_synth.py (the MSV1 runs' audio tracks): frames,
    headers, garbage and silence, byte for byte, for several rates."""
    from jsplayer_tpu.encode import mp3_synth as JS
    from jsplayer_tpu_torch.encode import mp3_synth as PS

    for kw in (dict(), dict(bitrate_idx=5, sampling_idx=1),
               dict(bitrate_idx=14, sampling_idx=2)):
        assert PS.make_frames(7, **kw) == JS.make_frames(7, **kw)
        assert PS.make_silence_frames(3, **kw) == \
            JS.make_silence_frames(3, **kw)
        assert PS.make_header(**kw) == JS.make_header(**kw)
    stream = JS.make_frames(5)[0]
    assert PS.with_garbage(stream) == JS.with_garbage(stream)


def test_stream_reader_resident_bytes_is_a_verbatim_copy():
    """StreamReader.resident_bytes, which tests/test_torch_streaming_ingest.py
    holds against the reference's on the same streams."""
    assert inspect.getsource(PReader.resident_bytes) == \
        inspect.getsource(JReader.resident_bytes)


@pytest.mark.parametrize("name", ["LanePack", "_pick_lanes", "_bucket_steps",
                                  "pack_to_bytes", "pack_from_bytes"])
def test_lane_transport_host_helper_is_a_verbatim_copy(name):
    assert inspect.getsource(getattr(PLT, name)) == \
        inspect.getsource(getattr(JLT, name))
    assert PLT._MAGIC == JLT._MAGIC


def test_lane_transport_encode_tiles_differs_only_in_its_encoder():
    """kernels/lane_transport.py's host part (whose outputs
    tests/test_torch_lane_transport.py pins): encode_tiles is the
    reference's but for the call of the lockstep encoder in place of
    rans_lanes.encode_lanes."""
    got = inspect.getsource(PLT.encode_tiles).splitlines()
    want = inspect.getsource(JLT.encode_tiles).splitlines()
    assert len(got) == len(want)
    diff = [(g, w) for g, w in zip(got, want) if g != w]
    assert diff == [(
        "    lane_bytes, states, ns = encode_lanes_lockstep(syms, freq, "
        "n_lanes)",
        "    lane_bytes, states, ns = rans_lanes.encode_lanes(syms, freq, "
        "n_lanes)")]

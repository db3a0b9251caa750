"""The port's Player (jsplayer_tpu_torch.player, with its Manager, lane
loader and host codecs) against the JAX package's, on the CPU.

Both Players run one script of operations (load, tick, play, pause, seek,
step, skip-stills, next-change, thumbnail, audio) on the same stream bytes
with the same injected clock (``Player._clock``); after every step the two
must agree exactly: the step's return value, the presented frame's RGBA,
``shown_time``, the position and playback time, the playing/first-shown/
gated flags, the decode cursor, the loaded range and the timecode.  The
scenarios are those of tests/test_player.py and tests/test_player_lane.py.

One difference is intended: the port's ``load()`` clears ``video_info``
before it opens a new source (reference host fault 2), so a source with no
video header raises instead of answering with the old stream's header."""

import math

import numpy as np
import pytest

from jsplayer_tpu.core.source import MemorySource as JMem
from jsplayer_tpu.encode.avi_mux import mux_avi, mux_avi_opendml
from jsplayer_tpu.encode.msv1_enc import encode_frame_16
from jsplayer_tpu.codecs.msvideo1 import from_rgb15
from jsplayer_tpu.player import Player as JPlayer
from jsplayer_tpu.player import PlayerConfig as JConfig
from jsplayer_tpu.transcode import transcode_to_lane
from jsplayer_tpu_torch.core.source import MemorySource as PMem
from jsplayer_tpu_torch.player import Player as PPlayer
from jsplayer_tpu_torch.player import PlayerConfig as PConfig
from test_player import X, make_msv1_avi, make_sp_avi
from test_torch_host_copies import plain


def tall_msv1_avi(changed_at, n=12, seed=3):
    """An MSV1 16-bit stream 64 rows tall whose changes sit above the
    36-line insignificant band (tests/test_player.py's skip-stills
    fixture)."""
    Y2 = 64
    rng = np.random.default_rng(seed)
    streams, prev = [], None
    for t in range(n):
        if prev is None:
            f = np.full((Y2, X), from_rgb15(0x0421), dtype=np.uint32)
        else:
            f = prev.reshape(Y2, X).copy()
            if t in changed_at:
                f[44:48, 8:16] = from_rgb15(int(rng.integers(0, 0x8000)))
        flat = f.reshape(-1)
        streams.append(encode_frame_16(flat, prev, X, Y2))
        prev = flat
    return mux_avi(streams, X, Y2, 16, codec="CRAM", fps=10.0,
                   keyflags=[i == 0 for i in range(n)])


def silent_av_avi(n=6, mp3_frames=20):
    """An MSV1 16-bit 32x24 stream at 15 fps with one chunk of silent MP3
    frames that the system codec decodes (tests/test_pcm.py's A/V
    fixture)."""
    from jsplayer_tpu.encode.mp3_synth import make_silence_frames

    W, H = 32, 24
    prev, pkts = None, []
    for i in range(n):
        f = np.full(W * H, from_rgb15(0x0421), dtype=np.uint32)
        f[: W * (i + 1)] = from_rgb15(0x7C00)
        pkts.append(encode_frame_16(f, prev, W, H))
        prev = f
    mp3, _, _ = make_silence_frames(mp3_frames)
    return mux_avi(pkts, W, H, 16, codec="CRAM", fps=15.0,
                   keyflags=[i == 0 for i in range(n)],
                   sound_chunks=[(0, mp3)])


def opendml_avi():
    """make_sp_avi's stream in the OpenDML layout (ix00 segments of 5)."""
    from jsplayer_tpu.core.chunkbuffer import ChunkBuffer
    from jsplayer_tpu.core.riff import AviDemuxer

    avi, _ = make_sp_avi(nframes=12, keyevery=4)
    buf, frames = ChunkBuffer(), []
    d = AviDemuxer(buf, on_frame=frames.append)
    d.start()
    buf.add_chunk(avi)
    d.pump()
    return mux_avi_opendml(frames, X, 32, 24, codec="SPV3",
                           keyflags=[i % 4 == 0 for i in range(len(frames))],
                           frames_per_ix=5)


SOURCES = {
    "sp": lambda: make_sp_avi()[0],
    "sp16": lambda: make_sp_avi(nframes=16, keyevery=4)[0],
    "sp8": lambda: make_sp_avi(nframes=8)[0],
    "msv1": lambda: make_msv1_avi()[0],
    "msv1_sound": lambda: make_msv1_avi(nframes=12, with_sound=True)[0],
    "msv1_8": lambda: make_msv1_avi(nframes=8)[0],
    "tall": lambda: tall_msv1_avi({4, 9}),
    "tall_skip": lambda: tall_msv1_avi({5}, n=10, seed=8),
    "opendml": opendml_avi,
    "silent_av": silent_av_avi,
    "lane_silent_av": lambda: transcode_to_lane(silent_av_avi(), window=4,
                                                K=2),
    "lane_sp": lambda: transcode_to_lane(make_sp_avi(nframes=16,
                                                     keyevery=4)[0],
                                         window=4, K=2),
    "lane_sp6": lambda: transcode_to_lane(make_sp_avi(nframes=16,
                                                      keyevery=4)[0],
                                          window=6, K=2),
    "lane_msv1": lambda: transcode_to_lane(make_msv1_avi(nframes=12,
                                                         with_sound=True)[0],
                                           window=4, K=2),
}


class Twin:
    """The reference's and the port's Player, driven by one script on one
    fake clock."""

    def __init__(self, **cfg):
        self.now = 0.0
        self.players = (JPlayer(JConfig(**cfg)), PPlayer(PConfig(**cfg)))
        for p in self.players:
            p._clock = lambda: self.now
        self.sources = {}

    def src(self, name):
        if name not in self.sources:
            self.sources[name] = SOURCES[name]()
        return self.sources[name]

    def both(self, fn):
        """fn(player, package index) on each Player → the two results as
        plain data; an exception is a result too (its type and text)."""
        out = []
        for i, p in enumerate(self.players):
            try:
                out.append(plain(fn(p, i)))
            except Exception as e:  # noqa: BLE001 — compared, not hidden
                out.append(("raised", type(e).__name__, str(e)))
        return out

    def same(self, fn, what=""):
        """both(fn), which must agree → the reference's result."""
        got = self.both(fn)
        assert got[1] == got[0], what
        return got[0]


def snapshot(p):
    """Everything a user of the Player can observe after a step."""
    m = p.manager
    if m is None:
        return {"manager": None, "playing": p.playing}
    rgba = m.get_rgba() if m.buffers else None
    return {
        "rgba": None if rgba is None else rgba.tobytes(),
        "shown_time": m.shown_time, "last_frame_drawn": m.last_frame_drawn,
        "next_frame_to_decode": m.next_frame_to_decode,
        "frame_of_interest": m.frame_of_interest,
        "position": p.position(), "current_time": p.current_time(),
        "playing": p.playing, "first_shown": p.first_shown,
        "auto_paused": p._auto_paused, "pending_skip": p._pending_skip,
        "start_pos": p.start_pos, "start_time": p.start_time,
        "loaded_range": p.loaded_range(), "worker_dot": p.worker_dot(),
        "timecode": p.timecode(), "audio_time": m.loaded_audio_time(),
        "video_info": plain(p.video_info),
    }


DECOMPRESSED = "decompressed"  # FrameResult.DECOMPRESSED as plain data


def tick(tw, what=""):
    return tw.same(lambda p, i: p.tick(), what)


def ticks(tw, n):
    for k in range(n):
        tick(tw, k)


def tick_until(tw, cond, limit=300):
    """Tick both Players together until cond(reference player) holds,
    which it must within `limit` ticks."""
    for k in range(limit):
        tick(tw, k)
        if cond(tw.players[0]):
            return
    raise AssertionError(f"not reached in {limit} ticks")


def playthrough(tw, nframes):
    """Present every frame on the fake clock (test_playthrough_sp)."""
    fps = tw.players[0].manager.fps
    for t in range(nframes):
        tw.now = t / fps + 0.001
        for _ in range(200):
            if tick(tw, t) == DECOMPRESSED:
                break
            tw.same(lambda p, i: p.playing or p.play())
        tw.same(lambda p, i: snapshot(p), t)


def next_change(tw):
    for _ in range(50):
        if tw.same(lambda p, i: p.next_change()) is not None:
            return
    raise AssertionError("next_change never resolved")


def pcm_bits(a):
    return None if a is None else (a.sample_rate, a.channels,
                                   a.samples.tobytes())


def run_script(script, **cfg):
    """Run `script` — a list of (op, *args) — on both Players; every op's
    results agree, and after every op the two snapshots are equal → the
    Twin."""
    tw = Twin(**cfg)

    def each(fn):
        return lambda *a: tw.same(lambda p, i: fn(p, i, *a))

    def repeat(fn):
        return lambda n: [tw.same(lambda p, i: fn(p)) for _ in range(n)]

    def stills(p, i, foi):
        p.manager.frame_of_interest = foi
        return p.manager.skip_stills(first_call=True)

    def gate(p, i, pos):  # a gated pause (test_load_over_live_player...)
        p._auto_paused, p.playing, p.start_pos = True, False, pos

    def watermark(p, i, frames):
        """The loaded-audio watermark held at `frames` frames (None: the
        whole stream), as test_audio_gating_autoresume pins it."""
        m = p.manager
        t = m.total_time() if frames is None else frames / m.fps
        m.loaded_audio_time = lambda: t

    def expect(key, value):  # the scenario reached the state it drives to
        assert snapshot(tw.players[0])[key] == value, (key, value)

    ops = {
        "load": each(lambda p, i, n: p.load((JMem, PMem)[i](tw.src(n)))),
        "until_shown": lambda: tick_until(tw, lambda p: p.first_shown, 500),
        "ticks": lambda n: ticks(tw, n),
        "until_frame": lambda f: tick_until(
            tw, lambda p: p.manager.last_frame_drawn == f),
        "clock": lambda t: setattr(tw, "now", t),
        "clock_frame": lambda f: setattr(
            tw, "now", f / tw.players[0].manager.fps + 0.001),
        "clock_end": lambda d: setattr(
            tw, "now", tw.players[0].manager.total_time() + d),
        "play": each(lambda p, i: p.play()),
        "pause": each(lambda p, i: p.pause()),
        "seek": each(lambda p, i, f: p.seek(f)),
        "seek_time": each(lambda p, i, t: p.seek_time(t)),
        "seek_frame": each(lambda p, i, f: p.seek_time(
            f / p.manager.fps + 0.001)),
        "step_frame": each(lambda p, i, fwd: p.step_frame(fwd)),
        "step_key": each(lambda p, i, fwd: p.step_key(fwd)),
        "next_change": lambda: next_change(tw),
        "worker": repeat(lambda p: p.manager.worker()),
        "parse_sound": repeat(lambda p: p.manager.loader.parse_sound()),
        "skip_stills": each(stills),
        "frame_changes": each(lambda p, i, n: [
            p.manager.loader.get_frame_changes(k) for k in range(n)]),
        "gate": each(gate),
        "watermark": each(watermark),
        "expect": expect,
        "thumbnail": each(lambda p, i: p.thumbnail().tobytes()),
        "resize": each(lambda p, i, w, h: p.resize(w, h)),
        "audio_pcm": each(lambda p, i: pcm_bits(p.audio_pcm())),
        "audio_slice": each(lambda p, i, t0, t1: (
            lambda s: None if s is None else s.tobytes())(
                p.audio_slice(t0, t1))),
        "playthrough": lambda n: playthrough(tw, n),
        "unload": each(lambda p, i: p.unload()),
    }
    for step, (op, *args) in enumerate(script):
        ops[op](*args)
        tw.same(lambda p, i: snapshot(p), (step, op, args))
    return tw


SEEK_AND_STEP = [("load", "sp16"), ("until_shown",), ("seek_frame", 10),
                 ("until_frame", 10), ("step_frame", True),
                 ("until_frame", 11), ("step_key", False), ("until_frame", 8),
                 ("step_key", True), ("ticks", 20), ("step_frame", False),
                 ("ticks", 20), ("seek", 0.25), ("ticks", 30), ("seek", 1.0),
                 ("ticks", 30), ("seek", 0.0), ("ticks", 30)]

SCENARIOS = {
    # tests/test_player.py
    "first_frame_msv1": [("load", "msv1"), ("until_shown",), ("ticks", 5)],
    "playthrough_sp": [("load", "sp"), ("until_shown",), ("clock", 0.0),
                       ("play",), ("playthrough", 12), ("ticks", 5)],
    "playthrough_msv1": [("load", "msv1"), ("until_shown",), ("play",),
                         ("playthrough", 12)],
    "seek_and_step": SEEK_AND_STEP,
    "skip_stills_band": [("load", "msv1"), ("until_shown",), ("worker", 300),
                         ("frame_changes", 12), ("skip_stills", 1)],
    "skip_stills_tall": [("load", "tall"), ("until_shown",), ("worker", 400),
                         ("frame_changes", 12), ("skip_stills", 0),
                         ("next_change",), ("ticks", 10), ("next_change",),
                         ("ticks", 10)],
    "audio_gating_pause": [("load", "msv1_sound"), ("until_shown",),
                           ("worker", 100), ("parse_sound", 1),
                           ("clock", 0.0), ("play",), ("clock_end", 10),
                           ("ticks", 1), ("expect", "playing", False),
                           ("expect", "auto_paused", False), ("ticks", 2)],
    "audio_gating_autoresume": [("load", "msv1_sound"), ("until_shown",),
                                ("watermark", 1), ("clock", 0.0), ("play",),
                                ("clock_frame", 3), ("ticks", 1),
                                ("expect", "auto_paused", True), ("ticks", 1),
                                ("expect", "auto_paused", True),
                                ("watermark", None), ("ticks", 1),
                                ("expect", "playing", True), ("ticks", 5)],
    "explicit_pause_after_gate": [("load", "msv1_sound"), ("until_shown",),
                                  ("watermark", 1), ("clock", 0.0),
                                  ("play",), ("clock_frame", 3),
                                  ("ticks", 1),
                                  ("expect", "auto_paused", True),
                                  ("pause",), ("watermark", None),
                                  ("ticks", 3), ("expect", "playing", False)],
    "reload_over_live": [("load", "msv1_sound"), ("until_shown",),
                         ("clock", 0.0), ("play",), ("gate", 0.37),
                         ("load", "msv1_8"), ("until_shown",),
                         ("playthrough", 8)],
    "opendml": [("load", "opendml"), ("until_shown",), ("seek_frame", 7),
                ("until_frame", 7), ("playthrough", 12)],
    "thumbnail_resize": [("load", "sp8"), ("thumbnail",), ("resize", 96, 64),
                         ("resize", 32, 288), ("resize", 10, 10)],
    "hostile_seeks": [("load", "sp16"), ("until_shown",),
                      ("seek_time", math.nan), ("ticks", 10),
                      ("seek_time", math.inf), ("ticks", 10),
                      ("seek_time", -math.inf), ("ticks", 10),
                      ("seek_time", -5.0), ("ticks", 10),
                      ("seek_time", 1e9), ("ticks", 10)],
    "paused_seek": [("load", "sp16"), ("until_shown",), ("pause",),
                    ("seek_frame", 13), ("ticks", 40), ("seek_frame", 3),
                    ("ticks", 40)],
    "audio_surface": [("load", "silent_av"), ("ticks", 200),
                      ("audio_pcm",), ("audio_slice", 0.0, 0.25),
                      ("audio_slice", 0.5, 0.6), ("load", "silent_av"),
                      ("ticks", 50), ("audio_pcm",), ("load", "msv1_sound"),
                      ("ticks", 50), ("audio_pcm",), ("unload",)],
    "lane_audio_surface": [("load", "lane_silent_av"), ("until_shown",),
                           ("audio_pcm",), ("audio_slice", 0.1, 0.3),
                           ("playthrough", 6)],
    # tests/test_player_lane.py
    "lane_playthrough": [("load", "lane_sp"), ("until_shown",), ("play",),
                         ("playthrough", 16)],
    "lane_seek_and_step": [("load", "lane_sp")] + SEEK_AND_STEP[1:],
    "lane_restart_windows": [("load", "lane_sp6"), ("until_shown",),
                             ("seek_frame", 14), ("until_frame", 14),
                             ("seek_frame", 5), ("until_frame", 5),
                             ("seek_frame", 9), ("until_frame", 9),
                             ("seek_frame", 2), ("until_frame", 2)],
    "lane_msv1_audio_stills": [("load", "lane_msv1"), ("until_shown",),
                               ("parse_sound", 100), ("frame_changes", 12),
                               ("next_change",), ("ticks", 10),
                               ("audio_pcm",), ("play",),
                               ("playthrough", 12)],
}


@pytest.mark.parametrize("indexed", [False, True])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_player_matches_reference(name, indexed):
    tw = run_script(SCENARIOS[name], indexed=indexed)
    assert tw.players[1].first_shown or name == "thumbnail_resize"


def test_autoskip_matches_reference():
    """autoskip (test_autoskip_jumps_over_stills): playback jumps past the
    stills of a stream with one significant change, in both Players."""
    tw = run_script([("load", "tall_skip"), ("until_shown",), ("worker", 400),
                     ("clock", 0.0), ("play",), ("clock_frame", 1),
                     ("ticks", 50)], indexed=False, autoskip=True)
    assert tw.players[1].manager.last_frame_drawn >= 5


@pytest.mark.parametrize("frac", [0.15, 0.5, 0.9])
def test_truncated_file_matches_reference(frac):
    """A truncated AVI (test_player_truncated_file): the same load result
    (a header or the same error), then the same ticks."""
    avi, _ = make_sp_avi(12)
    cut = avi[: int(len(avi) * frac)]
    tw = Twin(indexed=False)
    got = tw.same(lambda p, i: p.load((JMem, PMem)[i](cut)))
    if not isinstance(got, tuple):  # a header, not ("raised", ...)
        for k in range(200):
            tick(tw, k)
            tw.same(lambda p, i: snapshot(p), k)


@pytest.mark.parametrize("indexed", [False, True])
def test_reload_without_video_header_raises(indexed):
    """Reference host fault 2, repaired in the port: load() over a live
    player never clears video_info in the reference, so a second open that
    finds no video header returns the OLD stream's VideoInfo.  The port
    clears it before the open and raises ValueError."""
    avi, _ = make_sp_avi(8)
    header_less = avi[:40]  # the RIFF/hdrl lists begin; no avih, no strf
    j, p = JPlayer(JConfig(indexed=indexed)), PPlayer(PConfig(indexed=indexed))
    vj, vp = j.load(JMem(avi)), p.load(PMem(avi))
    assert plain(vp) == plain(vj) and vj.width == 32
    old = j.load(JMem(header_less))
    assert old is vj  # the fault: the old stream's header answers
    with pytest.raises(ValueError, match="no video header"):
        p.load(PMem(header_less))
    assert p.video_info is None
    # the port's player then loads a real stream again
    assert plain(p.load(PMem(avi))) == plain(vj)

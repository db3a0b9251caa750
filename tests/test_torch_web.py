"""The port's web server (jsplayer_tpu_torch.web.PlayerServer) against the
JAX package's, on the CPU.

Both servers wrap a Player over the same stream bytes on one fake clock
and take the same requests: ``info``, ``state`` (one UI tick each),
``frame_rgba``, every ``control`` verb and ``audio_wav`` must give equal
replies, byte for byte.  Then one HTTP round trip to each, each on an
ephemeral port, through the same endpoints (tests/test_web.py's)."""

import json
import math
import urllib.request

import pytest

from jsplayer_tpu.core.source import MemorySource as JMem
from jsplayer_tpu.player import PlayerConfig as JConfig
from jsplayer_tpu.transcode import transcode_to_lane
from jsplayer_tpu.web import PlayerServer as JServer
from jsplayer_tpu_torch.av import pcm
from jsplayer_tpu_torch.core.source import MemorySource as PMem
from jsplayer_tpu_torch.player import PlayerConfig as PConfig
from jsplayer_tpu_torch.web import PlayerServer as PServer
from test_player import make_sp_avi
from test_torch_player import silent_av_avi

STREAMS = {
    "sp": lambda: make_sp_avi(nframes=12, keyevery=4)[0],
    "av": lambda: silent_av_avi(n=12),
    "lane_av": lambda: transcode_to_lane(silent_av_avi(n=12), window=4,
                                         K=2),
}


def servers(data, **cfg):
    """The two servers over `data`, on one fake clock (not started)."""
    clock = [0.0]
    out = (JServer(JMem(data), JConfig(**cfg)),
           PServer(PMem(data), PConfig(**cfg)))
    for s in out:
        s.player._clock = lambda: clock[0]
    return out, clock


def same(pair, fn):
    """fn(server) on each → the reference's reply, which the port's must
    equal."""
    got = [fn(s) for s in pair]
    assert got[1] == got[0]
    return got[0]


#: one UI session: (verb, argument) for control, or a read endpoint
SESSION = ([("state",)] * 30 + [("frame_rgba",), ("info",),
           ("control", "play", None), ("clock", 0.25)] + [("state",)] * 10
           + [("frame_rgba",), ("control", "pause", None), ("state",),
              ("control", "seek", 0.5), ("state",), ("frame_rgba",),
              ("control", "step_frame", True), ("state",),
              ("control", "step_key", False), ("state",), ("frame_rgba",),
              ("control", "seek_time", 0.9), ("state",),
              ("control", "next_change", None), ("state",), ("frame_rgba",),
              ("control", "resize", [64, 48]), ("control", "bogus", None),
              ("control", "seek", 0.0), ("state",), ("frame_rgba",),
              ("audio_wav",), ("audio_wav",), ("state",)])


@pytest.mark.parametrize("name", sorted(STREAMS))
@pytest.mark.parametrize("indexed", [False, True])
def test_server_replies_match_reference(name, indexed):
    pair, clock = servers(STREAMS[name](), indexed=indexed)
    try:
        for step in SESSION:
            if step[0] == "clock":
                clock[0] = step[1]
            elif step[0] == "control":
                same(pair, lambda s: s.control(step[1], step[2]))
            else:
                same(pair, lambda s: getattr(s, step[0])())
        assert pair[1].frame_serial >= 0
        wav = pair[1].audio_wav()
        assert (wav is not None) == (name != "sp" and pcm.available())
    finally:
        for s in pair:
            s.httpd.server_close()


def test_wait_mode_and_hostile_controls_match_reference():
    """The deferred load (-Dwait) answers info before the first play and
    loads on it; hostile seek times clamp the same way in both."""
    pair, clock = servers(STREAMS["sp"](), indexed=False, wait=True,
                          thumb="t.png")
    try:
        assert same(pair, lambda s: s.info())["wait"] is True
        same(pair, lambda s: s.state())
        same(pair, lambda s: s.frame_rgba())
        assert same(pair, lambda s: s.control("play"))["ok"]
        for _ in range(20):
            same(pair, lambda s: s.state())
        for t in (math.nan, math.inf, -1.0, 1e9):
            same(pair, lambda s: s.control("seek_time", t))
            same(pair, lambda s: s.state())
        same(pair, lambda s: s.frame_rgba())
    finally:
        for s in pair:
            s.httpd.server_close()


def _get(srv, path):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}{path}", timeout=10) as r:
        return r.read()


def _post(srv, cmd, arg=None):
    body = json.dumps({"cmd": cmd, "arg": arg}).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}/control", data=body, method="POST",
        headers={"X-Control-Token": srv.control_token})
    with urllib.request.urlopen(req, timeout=10) as r:
        return json.loads(r.read())


def test_http_round_trip_matches_reference():
    """Each server on an ephemeral port: the page (its per-session control
    token aside), /info, /state, /frame.rgba, /control and /audio.wav over
    a real local connection give the reference's bytes."""
    pair, _ = servers(STREAMS["av"](), indexed=False)
    try:
        for s in pair:
            s.start()
        pages = [_get(s, "/").decode().replace(s.control_token, "TOKEN")
                 for s in pair]
        assert pages[1] == pages[0] and "spplay" in pages[0]
        same(pair, lambda s: json.loads(_get(s, "/info")))
        for _ in range(20):
            st = same(pair, lambda s: json.loads(_get(s, "/state")))
        assert st["frame_serial"] >= 0
        same(pair, lambda s: _get(s, "/frame.rgba"))
        same(pair, lambda s: _post(s, "play"))
        same(pair, lambda s: json.loads(_get(s, "/state")))
        same(pair, lambda s: _post(s, "seek", 0.5))
        same(pair, lambda s: _get(s, "/frame.rgba"))
        if pcm.available():
            assert len(same(pair, lambda s: _get(s, "/audio.wav"))) > 44
    finally:
        for s in pair:
            s.stop()

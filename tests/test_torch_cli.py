"""The port's command line (jsplayer_tpu_torch.__main__.main) against the
JAX package's, on the CPU.

The seven cases of tests/test_cli.py, each run through both packages'
``main`` on the same files: the JSON lines must be equal apart from wall
time (and the paths of the two output directories), the transcoded files,
the rendered frame files and the WAV byte for byte.  The port's two device
commands take ``--device cpu`` here; ``--device cuda`` raises where there
is no card."""

import json
import os
import queue
import threading
import urllib.request
from collections import Counter

import numpy as np
import pytest
import torch

from jsplayer_tpu.__main__ import main as jmain
from jsplayer_tpu.encode.avi_mux import mux_avi
from jsplayer_tpu.encode.mp3_synth import make_silence_frames
from jsplayer_tpu.encode.sp_enc import ScreenPressorEncoder, pack_rgb
from jsplayer_tpu.utils.logging import LOG as JLOG
from jsplayer_tpu_torch.__main__ import main as pmain
from jsplayer_tpu_torch.utils.logging import LOG as PLOG
from test_cli import avi_path  # noqa: F401 — the reference's fixture
from test_torch_player import silent_av_avi

#: JSON keys that read the wall clock
WALL = ("wall_seconds", "decode_fps", "frames_per_sec")


def run(capsys, monkeypatch, argv, device=None):
    """argv through both mains (device appended to the port's) → the two
    JSON results, wall-time keys dropped.  Each package's LOG counters
    start empty, so `play`'s counters cover this run alone."""
    outs = []
    for main, log, extra in ((jmain, JLOG, []),
                             (pmain, PLOG, ["--device", device] if device
                              else [])):
        monkeypatch.setattr(log, "counters", Counter())
        assert main(argv + extra) == 0
        res = json.loads(capsys.readouterr().out)
        outs.append({k: v for k, v in res.items() if k not in WALL})
    return outs


def test_cli_info(avi_path, capsys, monkeypatch):  # noqa: F811
    for argv in (["info", avi_path], ["info", avi_path, "--seq"]):
        j, p = run(capsys, monkeypatch, argv)
        assert p == j and p["width"] == 32


def test_cli_info_bad_file(tmp_path, capsys, monkeypatch):
    bad = tmp_path / "bad.avi"
    bad.write_bytes(b"RIFF" + bytes(8))
    got = []
    for main in (jmain, pmain):
        rc = main(["info", str(bad)])
        got.append((rc, capsys.readouterr().out))
    assert got[1] == got[0] and got[0][0] == 1


def test_cli_play(avi_path, capsys, monkeypatch):  # noqa: F811
    for argv in (["play", avi_path], ["play", avi_path, "--seq",
                                      "--autoskip"]):
        j, p = run(capsys, monkeypatch, argv)
        assert p == j and p["frames_presented"] > 0


@pytest.mark.parametrize("extra", [["--version", "4"], ["--version", "3"],
                                   ["--format", "lane", "--window", "4"],
                                   ["--format", "lane", "--window", "4",
                                    "--lane-payload", "rans",
                                    "--align", "stride", "--no-compress"]])
def test_cli_transcode(avi_path, tmp_path, capsys, monkeypatch,  # noqa: F811
                       extra):
    outs = [str(tmp_path / n) for n in ("j.out", "p.out")]
    got = []
    for main, out in zip((jmain, pmain), outs):
        assert main(["transcode", avi_path, out, "--jobs", "1"] + extra) == 0
        got.append(json.loads(capsys.readouterr().out))
    assert got[1] == got[0]
    data = [open(o, "rb").read() for o in outs]
    assert data[1] == data[0] and len(data[0]) > 100


def test_cli_ingest(avi_path, capsys, monkeypatch):  # noqa: F811
    j, p = run(capsys, monkeypatch, ["ingest", avi_path, "--window", "3"],
               device="cpu")
    assert p == j and p["frames_decoded"] == 6


@pytest.mark.parametrize("argv", [
    ["--window", "3", "--path", "kmv_sparse", "--downscale", "1"],
    ["--window", "3", "--elide"],
    ["--window", "4", "--elide", "--downscale", "2", "--model-only"],
])
def test_cli_ingest_sparse_elide(avi_path, capsys, monkeypatch,  # noqa: F811
                                 argv):
    j, p = run(capsys, monkeypatch, ["ingest", avi_path] + argv,
               device="cpu")
    assert p == j


def render_fixtures(tmp_path):
    """tests/test_cli.py's render streams: SP v3 (SCPR) video-only, the
    same with an MP3 track, and a 16bpp MSV1 stream with silent MP3."""
    W = H = 32
    enc = ScreenPressorEncoder(3, W, H, bpp=24)
    f = np.full(W * H, pack_rgb(10, 20, 200), dtype=np.uint32)
    pkts = [enc.encode_i(f)]
    g = f.copy()
    g[: W * 8] = pack_rgb(200, 20, 10)
    pkts.append(enc.encode_p(g))
    mp3, _, _ = make_silence_frames(5)
    out = {"v": mux_avi(pkts, W, H, 24, codec="SCPR",
                        keyflags=[True, False]),
           "av": mux_avi(pkts, W, H, 24, codec="SCPR",
                         keyflags=[True, False], sound_chunks=[(0, mp3)]),
           "msv1": silent_av_avi(n=6)}
    paths = {}
    for name, data in out.items():
        paths[name] = str(tmp_path / f"{name}.avi")
        with open(paths[name], "wb") as fh:
            fh.write(data)
    return paths


@pytest.mark.parametrize("name,extra", [("v", []), ("av", ["--wav"]),
                                        ("msv1", ["--wav", "--every", "2",
                                                  "--window", "4"])])
def test_cli_render_frames_and_wav(tmp_path, capsys, name, extra):
    """render: the same frame files (PNG through cv2, or PPM) and the same
    WAV as the reference's, byte for byte."""
    src = render_fixtures(tmp_path)[name]
    dirs = [str(tmp_path / d) for d in ("j", "p")]
    got = []
    for main, d, dev in ((jmain, dirs[0], []),
                         (pmain, dirs[1], ["--device", "cpu"])):
        assert main(["render", src, d] + extra + dev) == 0
        res = json.loads(capsys.readouterr().out)
        got.append(json.loads(json.dumps(res).replace(d, "OUT")))
    assert got[1] == got[0] and got[0]["frames_written"] > 0
    names = sorted(os.listdir(dirs[0]))
    assert sorted(os.listdir(dirs[1])) == names
    assert len(names) == got[0]["frames_written"] + bool(got[0]["wav"])
    for n in names:
        with open(os.path.join(dirs[0], n), "rb") as a, \
                open(os.path.join(dirs[1], n), "rb") as b:
            assert b.read() == a.read(), n
    if "--wav" in extra:
        from jsplayer_tpu_torch.av import pcm

        assert (got[0]["wav"] is not None) == pcm.available()


def test_cli_render_device_cuda_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the no-card path")
    src = render_fixtures(tmp_path)["v"]
    with pytest.raises(RuntimeError, match="cuda"):
        pmain(["render", src, str(tmp_path / "o")])  # the default: cuda
    with pytest.raises(RuntimeError, match="cuda"):
        pmain(["render", src, str(tmp_path / "o"), "--device", "cuda"])


def serve_once(main, mod, avi, monkeypatch):
    """`serve` through main() in a thread: the server binds its port when
    it is made, so the requests need no wait; stop() ends serve_forever
    and main returns → (/info, the page with its control token masked)."""
    made = queue.Queue()
    real = mod.PlayerServer.serve_forever

    def serve_forever(self):
        made.put(self)
        real(self)

    monkeypatch.setattr(mod.PlayerServer, "serve_forever", serve_forever)
    rc = []
    t = threading.Thread(target=lambda: rc.append(
        main(["serve", avi, "--port", "0"])))
    t.start()
    srv = made.get(timeout=30)
    try:
        base = f"http://127.0.0.1:{srv.port}"
        with urllib.request.urlopen(base + "/info", timeout=10) as r:
            info = json.loads(r.read())
        with urllib.request.urlopen(base + "/", timeout=10) as r:
            page = r.read().decode().replace(srv.control_token, "TOKEN")
    finally:
        srv.stop()
        t.join(timeout=30)
    assert rc == [0]
    return info, page


def test_cli_serve(avi_path, monkeypatch, capsys):  # noqa: F811
    from jsplayer_tpu import web as jweb
    from jsplayer_tpu_torch import web as pweb

    want = serve_once(jmain, jweb, avi_path, monkeypatch)
    got = serve_once(pmain, pweb, avi_path, monkeypatch)
    assert got == want
    assert got[0]["loaded"] and got[0]["width"] == 32
    assert "spplay" in got[1] and "<canvas" in got[1]
    capsys.readouterr()

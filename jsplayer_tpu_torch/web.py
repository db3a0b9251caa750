"""Browser player chrome — the Main.hx UI layer, served over HTTP.

Closes the one "headless by design" gap in the component inventory: the
reference's in-page player UI (Main.hx init_controls:515-720 — play/pause
button, seek bar with loaded-range fill and decode-ahead "worker dot",
timecode, next-change button, zoom, fullscreen) and its JS embed API
(ExternalInterface, Main.hx:1025-1034).  The decode stack stays exactly the
headless Player facade; this module adds

  * a stdlib ThreadingHTTPServer wrapping one Player behind a lock
    (endpoints: / page, /info, /state, /frame.rgba, /audio.wav, /control),
  * an embedded single-file HTML/JS page that renders frames to a canvas
    (the RGBA bytes from Manager.get_rgba are already canvas byte order —
    the reference's ABGR swizzle, Manager.hx:377-380) and implements the
    full control chrome,
  * the reference's JS API verbatim on window: spplay / sppause /
    spposition / spseek / spload / spnextchange / spresize, plus the
    on_player_loaded and on_next_btn page callbacks (Main.hx:1098-1102,
    760-762),
  * the six UI-color flashvars (buttonbg/buttonhover/buttonface/frame/
    loaded/textcolor, Main.hx:244-249) honored from PlayerConfig.colors,
  * MP3 audio playback: /audio.wav serves the Player's time-aligned PCM
    (av.pcm.AlignedPcm — the decodeAudioData analog, AudioTrack.hx:54-65)
    as a WAV the page plays through an <audio> element kept in sync with
    the video clock each UI tick; the Player's own loaded-audio gating
    (Main.hx:1082-1091) still pauses video that outruns audio.

The page polls /state at the reference's 50 ms UI tick (timer_play,
Main.hx:1037) and refetches the frame only when a new one was presented.
"""

from __future__ import annotations

import json
import secrets
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import urlsplit

from .core.source import open_source
from .player import Player, PlayerConfig

_DEFAULT_COLORS = {
    # Main.hx:244-249 flashvar defaults, as CSS colors
    "buttonbg": "#222222",
    "buttonhover": "#444444",
    "buttonface": "#dddddd",
    "frame": "#333333",
    "loaded": "#2a6fbb",
    "textcolor": "#dddddd",
}

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>jsplayer_tpu</title>
<style>
  body { background:#111; color:%(textcolor)s; font:13px monospace;
         display:flex; flex-direction:column; align-items:center; }
  #wrap { border:2px solid %(frame)s; display:inline-block; }
  canvas { display:block; image-rendering:pixelated; }
  #bar { display:flex; align-items:center; gap:6px; padding:6px;
         background:%(buttonbg)s; }
  button { background:%(buttonbg)s; color:%(buttonface)s;
           border:1px solid %(buttonface)s; font:13px monospace;
           cursor:pointer; }
  button:hover { background:%(buttonhover)s; }
  #seek { position:relative; flex:1; height:14px; background:#000;
          cursor:pointer; }
  #loaded { position:absolute; top:0; height:100%%; background:%(loaded)s;
            opacity:.45; }
  #pos { position:absolute; top:0; width:2px; height:100%%;
         background:%(buttonface)s; }
  #dot { position:absolute; top:4px; width:6px; height:6px;
         border-radius:3px; background:#e3b341; }
  #tc { min-width:72px; text-align:center; }
</style></head><body>
<div id="wrap"><canvas id="cv"></canvas>
<div id="bar">
  <button id="play" onclick="toggle()">&#9654;</button>
  <button onclick="spstep(-1)" title="prev frame">&#8249;</button>
  <button onclick="spstep(1)" title="next frame">&#8250;</button>
  <button onclick="spnextchange()" title="skip stills">&#8677;</button>
  <div id="seek" onclick="seekClick(event)">
    <div id="loaded"></div><div id="dot"></div><div id="pos"></div>
  </div>
  <span id="tc">00:00:00</span>
  <select id="zoom" onchange="applyZoom()">
    <option value="1">1x</option><option value="2">2x</option>
    <option value="0.5">0.5x</option><option value="fit">fit</option>
  </select>
  <button onclick="fullscreen()" title="fullscreen">&#9974;</button>
</div></div>
<audio id="au" preload="auto" style="display:none"></audio>
<script>
let info = null, lastSerial = -1, playing = false, hasAudio = false;
const cv = document.getElementById('cv'), ctx2 = () => cv.getContext('2d');
async function post(cmd, arg) {
  const r = await fetch('/control', {method:'POST',
    headers: {'X-Control-Token': '%(token)s'},
    body: JSON.stringify({cmd:cmd, arg:arg})});
  return r.json();
}
// ---- the reference's ExternalInterface JS API (Main.hx:1025-1034) ----
window.spplay = () => post('play');
window.sppause = () => post('pause');
window.spposition = async () => (await (await fetch('/state')).json()).position;
window.spseek = (frac) => post('seek', frac);
window.spload = (name) => post('load', name);
window.spnextchange = () => post('next_change').then(r => {
  if (r.next_change != null && window.on_next_btn) window.on_next_btn(r.next_change);
});
window.spresize = (w, h) => post('resize', [w, h]);
window.spstep = (dir) => post('step_frame', dir > 0);
function toggle() { playing ? sppause() : spplay(); }
function seekClick(ev) {
  const r = document.getElementById('seek').getBoundingClientRect();
  spseek((ev.clientX - r.left) / r.width);
}
function applyZoom() {
  const z = document.getElementById('zoom').value;
  if (!info) return;
  const el = domImg || cv;
  if (z === 'fit') { el.style.width = '90vw'; el.style.height = 'auto'; }
  else { el.style.width = (info.width * z) + 'px'; el.style.height = 'auto'; }
}
function fullscreen() { document.getElementById('wrap').requestFullscreen(); }
// ?dom=1 renders through an <img> DOM element instead of the canvas —
// the reference's -Ddom build variant (readme.txt:8-9 discusses its
// trade-offs; mk.bat builds it).  Same bytes, different presentation
// path: the RGBA frame is drawn to an offscreen canvas then swapped in
// as the img src.
const DOM_MODE = new URLSearchParams(location.search).get('dom') === '1';
let domImg = null;
async function drawFrame() {
  const buf = await (await fetch('/frame.rgba')).arrayBuffer();
  const img = new ImageData(new Uint8ClampedArray(buf), info.width, info.height);
  if (DOM_MODE) {
    if (!domImg) {
      domImg = document.createElement('img');
      domImg.id = 'cvimg';
      domImg.style.display = 'block';
      domImg.style.imageRendering = 'pixelated';
      cv.replaceWith(domImg);
    }
    const off = document.createElement('canvas');
    off.width = info.width; off.height = info.height;
    off.getContext('2d').putImageData(img, 0, 0);
    domImg.src = off.toDataURL();
    return;
  }
  ctx2().putImageData(img, 0, 0);
}
function syncAudio(st) {    // WebAudio playback analog (AudioTrack.Play)
  const au = document.getElementById('au');
  if (!hasAudio) return;
  if (st.playing) {
    if (Math.abs(au.currentTime - st.time) > 0.25) au.currentTime = st.time;
    if (au.paused) au.play().catch(() => {});  // autoplay may need a click
  } else if (!au.paused) au.pause();
}
async function uiTick() {   // the 50 ms play tick (Main.hx:1037)
  const st = await (await fetch('/state')).json();
  if (!st.ok) return;
  playing = st.playing;
  syncAudio(st);
  document.getElementById('play').innerHTML = playing ? '&#10074;&#10074;' : '&#9654;';
  document.getElementById('tc').textContent = st.timecode;
  const seek = document.getElementById('seek');
  const lw = seek.clientWidth;
  const ld = document.getElementById('loaded');
  ld.style.left = (st.loaded[0] * lw) + 'px';
  ld.style.width = ((st.loaded[1] - st.loaded[0]) * lw) + 'px';
  document.getElementById('pos').style.left = (st.position * lw) + 'px';
  document.getElementById('dot').style.left = (st.worker * lw) + 'px';
  if (st.frame_serial !== lastSerial) {
    lastSerial = st.frame_serial;
    await drawFrame();
    if (st.frame_serial >= 0 && window.on_player_loaded && !window._loadedFired) {
      window._loadedFired = true; window.on_player_loaded();
    }
  }
}
function initView() {
  cv.width = info.width; cv.height = info.height;
  applyZoom();
  const au = document.getElementById('au');
  au.addEventListener('error', () => { hasAudio = false; });
  au.addEventListener('canplay', () => { hasAudio = true; });
  au.src = '/audio.wav';   // 404s cleanly when the stream has no audio
  setInterval(uiTick, 50);
}
(async () => {
  info = await (await fetch('/info')).json();
  if (!info.loaded && info.wait) {
    // -Dwait deferred load (Main.hx:266-276, 406-426): thumbnail + start
    // button; the stream is fetched only when the user starts playback
    const ov = document.createElement('div');
    ov.id = 'waitov';
    if (info.thumb) {            // setAttribute, not innerHTML: the thumb
      const img = document.createElement('img');  // string must not inject
      img.src = info.thumb;                       // markup into the page
      ov.appendChild(img);
      ov.appendChild(document.createElement('br'));
    }
    const btn = document.createElement('button');
    btn.id = 'start';
    btn.textContent = '▶ start';
    ov.appendChild(btn);
    document.getElementById('wrap').prepend(ov);
    btn.onclick = async () => {
      const r = await post('play');
      if (r.ok === false) { btn.textContent = 'load failed — retry'; return; }
      ov.remove();
      info = await (await fetch('/info')).json();
      initView();
    };
    return;
  }
  initView();
})();
</script></body></html>
"""


class PlayerServer:
    """One Player behind a lock, exposed over HTTP for the page chrome."""

    def __init__(self, source=None, config: Optional[PlayerConfig] = None,
                 port: int = 0):
        self.player = Player(config or PlayerConfig())
        self.lock = threading.Lock()
        self.frame_serial = -1
        # -Dwait deferred load (Main.hx:266-276): park the source until the
        # page's start button (or spplay) asks for it
        self._deferred = None
        self._wav_cache: Optional[bytes] = None
        # per-session CSRF token: embedded in the served page, required
        # by /control (advisor r4 — a cross-origin POST is a
        # no-preflight simple request, so loopback binding alone does
        # not stop a hostile page from driving the player)
        self.control_token = secrets.token_hex(16)
        if source is not None:
            if self.player.config.wait:
                self._deferred = source
            else:
                self.load(source)
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _json(self, obj, code=200):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            # -- request-origin discipline (advisor r4, medium): the
            # server binds loopback, but that alone stops neither CSRF
            # (a cross-origin POST is a no-preflight simple request) nor
            # DNS rebinding (evil.com resolving to 127.0.0.1 makes
            # /frame.rgba readable cross-origin).  Three independent
            # gates: Host must name this loopback server (kills
            # rebinding for ALL endpoints), Origin — when a browser
            # sent one — must be a loopback origin (kills CSRF), and
            # /control additionally needs the per-session random token
            # the served page embeds (kills anything that slips both).

            def _local_host(self):
                host = (self.headers.get("Host") or "").strip().lower()
                if host.startswith("["):          # [::1]:port
                    name = host.split("]", 1)[0] + "]"
                else:
                    name = host.split(":", 1)[0]
                return name in ("127.0.0.1", "localhost", "[::1]")

            def _local_origin(self):
                origin = (self.headers.get("Origin") or "").strip()
                if not origin:
                    return True  # non-browser client (curl, tests)
                try:
                    h = urlsplit(origin).hostname
                except ValueError:
                    return False
                return h in ("127.0.0.1", "localhost", "::1")

            def do_GET(self):
                try:
                    self._get_routes()
                except (BrokenPipeError, ConnectionResetError):
                    pass  # client went away mid-write
                except Exception as e:  # noqa: BLE001 — always answer
                    try:
                        self._json(
                            {"error": f"{type(e).__name__}: {e}"}, 500)
                    except OSError:
                        pass

            def _get_routes(self):
                if not self._local_host():
                    return self._json({"error": "forbidden host"}, 403)
                # strip the query: /?dom=1 must serve the page, not 404
                path = self.path.split("?", 1)[0]
                if path in ("/", "/index.html"):
                    colors = dict(_DEFAULT_COLORS)
                    colors.update(outer.player.config.colors or {})
                    colors["token"] = outer.control_token
                    body = (_PAGE % colors).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif path == "/info":
                    self._json(outer.info())
                elif path == "/state":
                    self._json(outer.state())
                elif path == "/frame.rgba":
                    data = outer.frame_rgba()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "application/octet-stream")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                elif path == "/audio.wav":
                    data = outer.audio_wav()
                    if data is None:
                        return self._json({"error": "no audio"}, 404)
                    # byte-range support: browsers (Safari especially)
                    # require it for media elements
                    rng = self.headers.get("Range", "")
                    lo, hi = 0, len(data) - 1
                    partial = False
                    if rng.startswith("bytes="):
                        try:
                            s, _, e = rng[6:].partition("-")
                            lo = int(s) if s else 0
                            hi = int(e) if e else len(data) - 1
                            partial = True
                        except ValueError:
                            lo, hi, partial = 0, len(data) - 1, False
                    if partial and (lo > hi or lo >= len(data)):
                        self.send_response(416)
                        self.send_header("Content-Range",
                                         f"bytes */{len(data)}")
                        self.end_headers()
                        return
                    hi = min(hi, len(data) - 1)
                    body = data[lo : hi + 1]
                    self.send_response(206 if partial else 200)
                    if partial:
                        self.send_header("Content-Range",
                                         f"bytes {lo}-{hi}/{len(data)}")
                    self.send_header("Accept-Ranges", "bytes")
                    self.send_header("Content-Type", "audio/wav")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self._json({"error": "not found"}, 404)

            def do_POST(self):
                try:
                    self._post_control()
                except (BrokenPipeError, ConnectionResetError):
                    pass  # client went away mid-write
                except Exception as e:  # noqa: BLE001 — always answer
                    try:
                        self._json(
                            {"error": f"{type(e).__name__}: {e}"}, 500)
                    except OSError:
                        pass

            def _post_control(self):
                if self.path.split("?", 1)[0] != "/control":
                    return self._json({"error": "not found"}, 404)
                if not (self._local_host() and self._local_origin()):
                    return self._json({"error": "forbidden"}, 403)
                try:
                    # a malformed Content-Length is page-supplied input
                    # too — it must 400, not escape to the 500 handler
                    # (negative would read-to-EOF and hang keep-alive;
                    # huge would allocate unboundedly)
                    n = int(self.headers.get("Content-Length", 0))
                    if not 0 <= n <= (1 << 20):
                        raise ValueError("bad content-length")
                    req = json.loads(self.rfile.read(n) or b"{}")
                    if not isinstance(req, dict):
                        # valid JSON that isn't an object ("6", "[1]",
                        # "null") would AttributeError on .get → 500
                        raise ValueError("body must be a JSON object")
                    token = (self.headers.get("X-Control-Token")
                             or req.get("token"))
                    if not secrets.compare_digest(
                            str(token or ""), outer.control_token):
                        # state-changing verbs need the per-session
                        # token the served page embeds
                        return self._json({"error": "bad token"}, 403)
                    self._json(outer.control(req.get("cmd", ""),
                                             req.get("arg")))
                except (ValueError, KeyError, TypeError, OverflowError,
                        OSError) as e:
                    # page-supplied input must never kill the request
                    # thread silently: None/dict args raise TypeError,
                    # inf→int raises OverflowError, load of a missing
                    # path raises FileNotFoundError — all are 400s
                    self._json({"error": str(e)}, 400)

        self.httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    # -- player operations (all under the lock: Player is single-threaded
    # by design, like the reference's cooperative timers) ------------------

    def load(self, source) -> None:
        with self.lock:
            if isinstance(source, (str, bytes)):
                source = open_source(source)
            self.player.load(source)
            self.frame_serial = -1
            self._wav_cache = None  # re-decoded lazily per loaded stream

    def info(self) -> dict:
        with self.lock:
            vi = self.player.video_info
            if vi is None:
                return {"loaded": False,
                        "wait": self._deferred is not None,
                        "thumb": self.player.config.thumb or None}
            return {"loaded": True, "width": vi.width, "height": vi.height,
                    "fps": vi.fps, "nframes": vi.nframes,
                    "total_time": self.player.manager.total_time()}

    def state(self) -> dict:
        from .pipeline.manager import FrameResult

        with self.lock:
            p = self.player
            if p.manager is None:
                return {"ok": False}
            res = p.tick()
            if res == FrameResult.DECOMPRESSED:
                serial = p.manager.last_frame_drawn
                if serial != self.frame_serial:
                    self.frame_serial = serial
            return {"ok": True, "playing": p.playing,
                    "position": p.position(),
                    "time": p.current_time(),
                    "timecode": p.timecode(),
                    "loaded": list(p.loaded_range()),
                    "worker": p.worker_dot(),
                    "frame_serial": self.frame_serial}

    def frame_rgba(self) -> bytes:
        with self.lock:
            m = self.player.manager
            rgba = m.get_rgba() if m is not None else None
            if rgba is None:
                vi = self.player.video_info
                if vi is None:
                    return b""
                return bytes(vi.width * vi.height * 4)  # black until 1st frame
            # u32 little-endian ABGR words == R,G,B,A byte order — exactly
            # what canvas ImageData wants (Manager.hx:377-380 swizzle)
            return rgba.tobytes()

    def audio_wav(self) -> Optional[bytes]:
        """The stream's decoded audio as a 16-bit PCM WAV, or None without
        audio (or without the codec backend) — the page's <audio> source.
        The WAV covers the whole aligned timeline so browser currentTime
        IS the player clock.  Built once per loaded stream (cached); the
        worker drive runs in SHORT lock-released batches so /state and
        /control stay responsive while audio assembles, and is bounded by
        wall clock — an indexed loader whose memory window evicts never
        reaches a stable 'fully loaded' state."""
        import struct
        import time

        import numpy as np

        with self.lock:
            if self._wav_cache is not None:
                return self._wav_cache or None  # b"" caches "no audio"
            if self.player.manager is None:
                return None
        # drive the worker until the audio side stops progressing —
        # demux/MP3 parse advance with the decode ticks (the reference
        # piggybacks ParseSound on the worker, Manager.hx:478-481)
        stale = 0
        deadline = time.monotonic() + 10.0
        for _ in range(256):
            with self.lock:
                p = self.player
                if p.manager is None:
                    return None
                mp = p.manager.loader.mp3_parser
                before = (p.loaded_range()[1], mp.frames_processed,
                          len(mp.sections), mp.parsing_complete)
                for _ in range(64):
                    p.tick()
                mp = p.manager.loader.mp3_parser
                after = (p.loaded_range()[1], mp.frames_processed,
                         len(mp.sections), mp.parsing_complete)
            stale = stale + 1 if after == before else 0
            if stale >= 3 or time.monotonic() > deadline:
                break
        with self.lock:
            p = self.player
            try:
                pcm = p.audio_pcm()
            except RuntimeError:  # codec backend unavailable
                return None
            if pcm is None or pcm.samples.shape[0] == 0:
                self._wav_cache = b""
                return None
            i16 = np.clip(pcm.samples, -1.0, 1.0)
            i16 = (i16 * 32767.0).astype("<i2")
            data = i16.tobytes()
            ch, rate = pcm.channels, pcm.sample_rate
            hdr = (b"RIFF"
                   + struct.pack("<I", 36 + len(data))
                   + b"WAVEfmt "
                   + struct.pack("<IHHIIHH", 16, 1, ch, rate,
                                 rate * ch * 2, ch * 2, 16)
                   + b"data" + struct.pack("<I", len(data)))
            self._wav_cache = hdr + data
            return self._wav_cache

    def control(self, cmd: str, arg=None) -> dict:
        with self.lock:
            p = self.player
            if cmd == "play":
                if p.manager is None and self._deferred is not None:
                    # deferred start: first play loads the parked source
                    # (Main.hx:406-426 start-button path).  A failed load
                    # re-parks the source so a later play can retry, and
                    # reports the error instead of letting it escape the
                    # handler (which would leave wait mode silently dead)
                    src, self._deferred = self._deferred, None
                    self.lock.release()
                    try:
                        self.load(src)
                    except Exception as e:  # noqa: BLE001 — report, re-park
                        self._deferred = src
                        return {"ok": False, "error": f"load failed: {e}"}
                    finally:
                        self.lock.acquire()
                p.play()
            elif cmd == "pause":
                p.pause()
            elif cmd == "seek":
                p.seek(float(arg))
            elif cmd == "seek_time":
                p.seek_time(float(arg))
            elif cmd == "step_frame":
                p.step_frame(bool(arg))
            elif cmd == "step_key":
                p.step_key(bool(arg))
            elif cmd == "next_change":
                t = None
                for _ in range(1000):  # THINK_LIMIT slices (Manager.hx:287)
                    t = p.next_change()
                    if t is not None:
                        break
                return {"ok": True, "next_change": t}
            elif cmd == "resize":
                w, h = arg
                return {"ok": True, "size": list(p.resize(int(w), int(h)))}
            elif cmd == "load":
                if isinstance(arg, str):
                    self.lock.release()
                    try:
                        self.load(arg)
                    finally:
                        self.lock.acquire()
            else:
                return {"ok": False, "error": f"unknown cmd {cmd!r}"}
            return {"ok": True}

    # -- lifecycle --------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def serve_forever(self) -> None:
        print(f"jsplayer_tpu player at http://127.0.0.1:{self.port}/")
        self.httpd.serve_forever()

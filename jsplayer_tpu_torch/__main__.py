"""Command-line surface of the port: info / play / transcode / ingest /
render / serve.

  python -m jsplayer_tpu_torch info file.avi          # metadata + indexes
  python -m jsplayer_tpu_torch play file.avi          # headless playback
  python -m jsplayer_tpu_torch transcode in.avi out.avi --version 4
  python -m jsplayer_tpu_torch transcode in.avi out.jlv --format lane
  python -m jsplayer_tpu_torch ingest a.avi b.avi --device cuda
  python -m jsplayer_tpu_torch render file.avi out/ --wav --device cuda
  python -m jsplayer_tpu_torch serve file.avi         # browser player UI

Flags and JSON result lines are those of ``python -m jsplayer_tpu``, plus
``--device`` on the two commands that run the device stage (ingest and
render; ``cuda`` raises when there is no card, ``cpu`` runs the plain
versions).  info, play, transcode and serve are host-only, as in the JAX
package.  Lane containers (.jlv) take the lane path with or without
``--path lane``; MSVideo1 AVIs take the MSV1 paint path whatever
``--path`` says.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def cmd_info(args) -> int:
    from .core.source import open_source
    from .player import Player, PlayerConfig

    p = Player(PlayerConfig(indexed=not args.seq))
    try:
        vi = p.load(open_source(args.file))
    except ValueError as e:
        print(json.dumps({"error": str(e)}))
        return 1
    loader = p.manager.loader
    out = {
        "width": vi.width, "height": vi.height, "bpp": vi.bpp,
        "fps": round(vi.fps, 3), "nframes": vi.nframes,
        "codec": vi.codec.value,
        "has_palette": vi.palette is not None,
        "riff_size": vi.riff_size,
        "indexes": len(loader.indexes or []),
        "audio_indexes": len(loader.audio_indexes or []),
    }
    print(json.dumps(out, indent=2))
    return 0


def cmd_play(args) -> int:
    from .core.source import open_source
    from .pipeline.manager import FrameResult
    from .player import Player, PlayerConfig
    from .utils.logging import LOG

    p = Player(PlayerConfig(indexed=not args.seq, autoskip=args.autoskip))
    vi = p.load(open_source(args.file))
    t0 = time.monotonic()
    shown = 0
    for _ in range(100000):
        res = p.tick()
        if res == FrameResult.DECOMPRESSED and p.first_shown:
            break
    p.play()
    fake = [0.0]
    p._clock = lambda: fake[0]
    p.play()
    for i in range(vi.nframes):
        fake[0] = i / vi.fps + 0.001
        for _ in range(500):
            if p.tick() == FrameResult.DECOMPRESSED:
                shown += 1
                break
            if not p.playing:
                p.play()
    dt = time.monotonic() - t0
    print(json.dumps({
        "frames_presented": shown,
        "wall_seconds": round(dt, 3),
        "decode_fps": round(vi.nframes / dt, 1) if dt else None,
        "counters": dict(LOG.counters),
    }, indent=2))
    return 0


def cmd_transcode(args) -> int:
    with open(args.infile, "rb") as f:
        data = f.read()
    if getattr(args, "format", "avi") == "lane":
        from .transcode import transcode_to_lane

        out = transcode_to_lane(data, window=args.window, K=args.kmv_k,
                                payload=args.lane_payload,
                                compress=not args.no_compress,
                                align=args.align,
                                jobs=getattr(args, "jobs", 1))
        desc = {"format": "lane", "window": args.window,
                "payload": args.lane_payload, "align": args.align}
    else:
        from .transcode import transcode_sp

        out = transcode_sp(data, target_version=args.version,
                           jobs=getattr(args, 'jobs', 1))
        desc = {"version": args.version}
    with open(args.outfile, "wb") as f:
        f.write(out)
    print(json.dumps({"in_bytes": len(data), "out_bytes": len(out), **desc}))
    return 0


def cmd_render(args) -> int:
    """Materialize the stream: decoded frames as PNG (cv2) or PPM
    (pure-Python fallback) plus decoded audio as WAV — the headless
    rendering surface standing in for the reference's canvas + WebAudio."""
    import os

    import numpy as np

    from .core.source import open_source
    from .device import torch_to_u32
    from .pipeline.ingest import IngestConfig, VideoIngestPipeline

    os.makedirs(args.outdir, exist_ok=True)
    pipe = VideoIngestPipeline(
        [open_source(args.file)],
        IngestConfig(window=args.window, emit_model_input=False,
                     device=args.device))
    vi = pipe.info
    try:
        import cv2
    except ImportError:
        cv2 = None
    written = 0
    for batch in pipe:
        frames = torch_to_u32(batch["frames_u32"])  # [1, T, Y, X] u32
        start = batch["start_frame"]
        for t in range(frames.shape[1]):
            gi = start + t
            if gi >= vi.nframes or gi % args.every:
                continue
            # stored bottom-up (AVI order; Main.hx:318 displays negative-Y);
            # u32 channel order: HIGH byte is displayed RED for both codecs
            # (reference canvas swizzle, Manager.hx:377-380; see
            # kernels/rgb_convert.split_channels)
            img = frames[0, t][::-1]
            b = (img & 0xFF).astype(np.uint8)
            g = ((img >> 8) & 0xFF).astype(np.uint8)
            r = ((img >> 16) & 0xFF).astype(np.uint8)
            from .core.types import CodecType
            if vi.bpp == 16 and vi.codec == CodecType.SCREENPRESSOR:
                b, g, r = b << 3, g << 3, r << 3  # 5-bit display scaling
            rgb = np.stack([r, g, b], axis=-1)
            bgr = np.stack([b, g, r], axis=-1)
            if cv2 is not None:
                cv2.imwrite(os.path.join(args.outdir, f"frame_{gi:06d}.png"),
                            bgr)
            else:  # PPM: portable, zero-dependency
                with open(os.path.join(args.outdir, f"frame_{gi:06d}.ppm"),
                          "wb") as f:
                    f.write(b"P6\n%d %d\n255\n" % (vi.width, vi.height))
                    f.write(rgb.tobytes())
            written += 1
    wav = None
    if args.wav:
        from .av import pcm as _pcm

        if _pcm.available():
            aligned = pipe.audio_pcm()[0]
            if aligned is not None:
                import wave

                wav = os.path.join(args.outdir, "audio.wav")
                s16 = np.clip(aligned.samples * 32767.0,
                              -32768, 32767).astype("<i2")
                with wave.open(wav, "wb") as w:
                    w.setnchannels(aligned.channels)
                    w.setsampwidth(2)
                    w.setframerate(aligned.sample_rate)
                    w.writeframes(s16.tobytes())
    print(json.dumps({"frames_written": written, "outdir": args.outdir,
                      "format": "png" if cv2 is not None else "ppm",
                      "wav": wav}))
    return 0


def cmd_ingest(args) -> int:
    import torch

    from .core.source import open_source
    from .pipeline.ingest import IngestConfig, VideoIngestPipeline

    pipe = VideoIngestPipeline(
        [open_source(f) for f in args.files],
        IngestConfig(window=args.window, sp_device_path=args.path,
                     model_downscale=args.downscale,
                     emit_frames=not args.model_only,
                     sparse_lane_payload=args.lane_payload,
                     streaming=args.streaming,
                     still_elision=args.elide,
                     device=args.device),
    )
    t0 = time.monotonic()
    n = 0
    for batch in pipe:
        mi = batch.get("model_input")
        if mi is None:  # all-stills elided window: nothing hit the device
            print(f"window @{batch['start_frame']}: all stills (elided)",
                  file=sys.stderr)
            continue
        om = batch.get("outmap")
        # delivered frames: every timeline slot for elided windows (stills
        # alias decoded rows via outmap), window length otherwise
        n += om.size if om is not None else mi.shape[0] * mi.shape[1]
        print(f"window @{batch['start_frame']}: model_input "
              f"{tuple(mi.shape)} {mi.dtype}", file=sys.stderr)
    if pipe.device.type == "cuda":
        torch.cuda.synchronize(pipe.device)
    dt = time.monotonic() - t0
    print(json.dumps({"streams": len(args.files), "frames_decoded": n,
                      "wall_seconds": round(dt, 3),
                      "frames_per_sec": round(n / dt, 1) if dt else None}))
    return 0


def cmd_serve(args) -> int:
    from .player import PlayerConfig
    from .web import PlayerServer

    srv = PlayerServer(args.file,
                       PlayerConfig(indexed=not args.seq, wait=args.wait,
                                    thumb=args.thumb),
                       port=args.port)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        srv.stop()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="jsplayer_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    a = sub.add_parser("info", help="stream metadata")
    a.add_argument("file")
    a.add_argument("--seq", action="store_true", help="sequential loader")
    a.set_defaults(fn=cmd_info)

    a = sub.add_parser("play", help="headless playback run")
    a.add_argument("file")
    a.add_argument("--seq", action="store_true")
    a.add_argument("--autoskip", action="store_true")
    a.set_defaults(fn=cmd_play)

    a = sub.add_parser("transcode", help="re-encode SP stream")
    a.add_argument("infile")
    a.add_argument("outfile")
    a.add_argument("--version", type=int, default=4, choices=(2, 3, 4))
    a.add_argument("--jobs", type=int, default=0,
                   help="GOP-parallel workers (0 = all cores)")
    a.add_argument("--format", choices=("avi", "lane"), default="avi",
                   help="lane = device-entropy lane container "
                        "(ingest --path lane)")
    a.add_argument("--window", type=int, default=64,
                   help="lane container frames per window")
    a.add_argument("--kmv-k", type=int, default=2, dest="kmv_k")
    a.add_argument("--lane-payload", choices=("raw", "rans"), default="raw",
                   help="lane payload mode: raw unit bytes (default; zero"
                        " device entropy work) or device-decoded rANS lanes")
    a.add_argument("--align", choices=("keyframes", "stride"),
                   default="keyframes",
                   help="lane window boundaries: snap to keyframes (seekable"
                        " restart windows) or fixed stride (heterogeneous"
                        " archives stay batchable)")
    a.add_argument("--no-compress", action="store_true",
                   help="skip the at-rest deflate framing of lane windows")
    a.set_defaults(fn=cmd_transcode)

    a = sub.add_parser("render", help="decode to image files (+WAV audio)")
    a.add_argument("file")
    a.add_argument("outdir")
    a.add_argument("--every", type=int, default=1,
                   help="write every Nth frame")
    a.add_argument("--window", type=int, default=16)
    a.add_argument("--wav", action="store_true",
                   help="also decode audio to audio.wav")
    a.add_argument("--device", default="cuda",
                   help="torch device of the device stage (cuda raises "
                        "when there is no card; cpu runs the plain twins)")
    a.set_defaults(fn=cmd_render)

    a = sub.add_parser("ingest", help="batched decode to model tensors")
    a.add_argument("files", nargs="+")
    a.add_argument("--window", type=int, default=16)
    a.add_argument("--path", default="kmv",
                   choices=("kmv", "bc", "kmv_sparse", "lane", "general",
                            "pallas"),
                   help="SP device compose; lane-container sources take "
                        "lane and MSVideo1 AVIs their paint path whatever "
                        "this says")
    a.add_argument("--downscale", type=int, default=1,
                   help="power-of-two box downsample in the model epilogue")
    a.add_argument("--model-only", action="store_true",
                   help="fused model emission; skip full-res frame stacks")
    a.add_argument("--elide", action="store_true",
                   help="still-elision (single-stream exact or batched"
                        " bucketed compaction)")
    a.add_argument("--streaming", action="store_true",
                   help="windowed-memory demux: O(window) host residency"
                        " for multi-hour streams")
    a.add_argument("--lane-payload", action="store_true",
                   help="kmv_sparse only: rANS-coded tile payload, "
                        "entropy-decoded on the device")
    a.add_argument("--device", default="cuda",
                   help="torch device of the device stage (cuda raises "
                        "when there is no card; cpu runs the plain twins)")
    a.set_defaults(fn=cmd_ingest)

    a = sub.add_parser("serve", help="browser player UI over HTTP")
    a.add_argument("file")
    a.add_argument("--port", type=int, default=8470)
    a.add_argument("--seq", action="store_true", help="sequential loader")
    a.add_argument("--wait", action="store_true",
                   help="defer stream load until playback starts "
                        "(the reference's -Dwait mode)")
    a.add_argument("--thumb", default="",
                   help="thumbnail image URL for the --wait start overlay")
    a.set_defaults(fn=cmd_serve)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())

"""Command-line surface of the port: ingest.

  python -m jsplayer_tpu_torch ingest a.avi b.avi --device cuda

Flags and the JSON result line are those of ``python -m jsplayer_tpu
ingest``, plus --device.  The other subcommands of the JAX package are not
ported yet.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def cmd_ingest(args) -> int:
    import torch

    from jsplayer_tpu.core.source import open_source

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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="jsplayer_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    a = sub.add_parser("ingest", help="batched decode to model tensors")
    a.add_argument("files", nargs="+")
    a.add_argument("--window", type=int, default=16)
    a.add_argument("--path", default="kmv",
                   choices=("kmv", "bc", "kmv_sparse", "lane", "general",
                            "pallas"),
                   help="SP device compose (only kmv is ported; the others "
                        "raise NotImplementedError)")
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
                   help="kmv_sparse only (not ported)")
    a.add_argument("--device", default="cuda",
                   help="torch device of the device stage (cuda raises "
                        "when there is no card; cpu runs the plain twins)")
    a.set_defaults(fn=cmd_ingest)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())

"""The port's multi-process path: a REAL 2-process torch.distributed group
over gloo (tests/test_multihost.py's twin).

The test starts this file's own ``__main__`` twice.  Each process joins
through ``pipeline.mesh.init_multihost(backend="gloo")``, builds one
(dp=4, gop=1) mesh of CPU slots that spans both processes (2 slots each),
runs the sharded kmv and bc steps and the lane-container ingest over it,
holds the rows it owns (``Mesh.local_rows``) against the source frames
bit for bit, and runs the mesh's psum, an all_reduce across the two
processes.  The child imports nothing of JAX.
"""

import os
import socket
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_distributed_decode():
    coordinator = f"127.0.0.1:{_free_port()}"
    procs = [
        subprocess.Popen(
            [sys.executable, "-u", os.path.abspath(__file__), coordinator,
             "2", str(i)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=ROOT)
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} rc={p.returncode}:\n{out[-3000:]}"
        assert f"MULTIHOST_OK proc={i} slots=4 checked=2" in out, out[-3000:]


def main() -> None:
    coordinator, nprocs, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    sys.path.insert(0, ROOT)

    import numpy as np
    import torch

    torch.set_num_threads(1)
    from jsplayer_tpu_torch.core.source import MemorySource
    from jsplayer_tpu_torch.device import torch_to_u32
    from jsplayer_tpu_torch.encode.avi_mux import mux_avi
    from jsplayer_tpu_torch.encode.sp_enc import ScreenPressorEncoder, pack_rgb
    from jsplayer_tpu_torch.kernels import sp_recon
    from jsplayer_tpu_torch.pipeline.batch import (DecodeConfig,
                                                   make_sp_decode_step_bc,
                                                   make_sp_decode_step_kmv,
                                                   stack_sp_commands)
    from jsplayer_tpu_torch.pipeline.ingest import (IngestConfig,
                                                    VideoIngestPipeline)
    from jsplayer_tpu_torch.pipeline.mesh import init_multihost, make_mesh
    from jsplayer_tpu_torch.transcode import transcode_to_lane

    init_multihost(coordinator, nprocs, pid, backend="gloo")
    mesh = make_mesh(dp=4, gop=1, devices=["cpu"] * 2)
    assert mesh.devices.size == 2 * nprocs
    X = Y = 32
    B, T = mesh.devices.size, 4  # one stream a slot on the dp axis
    # identical deterministic content on every process
    streams, golds = [], []
    for b in range(B):
        enc = ScreenPressorEncoder(4, X, Y)
        rng = np.random.default_rng(100 + b)
        f = np.full((Y, X), pack_rgb(b, 3, 5), dtype=np.uint32).reshape(-1)
        ss, gg = [enc.encode_i(f)], [f]
        for _ in range(T - 1):
            g = f.copy().reshape(Y, X)
            g[2:, :] = g[:-2, :]  # scroll → motion
            g[4:8, 4:12] = pack_rgb(*rng.integers(0, 256, 3))
            f = g.reshape(-1)
            ss.append(enc.encode_p(f))
            gg.append(f)
        streams.append(ss)
        golds.append(gg)
    cmds = stack_sp_commands(streams, X, Y, gops=1)
    rows = mesh.local_rows(B)
    assert len(rows) == 2 and rows.start == 2 * pid, rows

    def check(frames, what, mask=0xFFFFFFFF):
        got = torch_to_u32(frames)
        assert got.shape[0] == len(rows), (what, got.shape)
        for k, b in enumerate(rows):
            for t in range(T):
                np.testing.assert_array_equal(
                    got[k, t].reshape(-1) & mask, golds[b][t] & mask,
                    err_msg=f"{what} proc {pid} stream {b} frame {t}")

    cfg = DecodeConfig(height=Y, width=X, emit_model_input=False)
    pcs = np.zeros((B, 1, T, Y, X), dtype=np.uint32)
    mvks = np.zeros((B, 1, T, 2, 2), dtype=np.int32)
    nb = ((X + 15) // 16) * ((Y + 15) // 16)
    bc = [np.zeros((B, 1, T) + s, dtype=d) for s, d in (
        ((Y, X), np.uint32), ((nb,), np.uint8), ((nb, 4), np.uint8),
        ((2, 2), np.int32))]
    for b in range(B):
        pcs[b, 0], mvks[b, 0] = sp_recon.prepare_kmv(
            cmds["bts"][b, 0], cmds["mv"][b, 0], cmds["rect"][b, 0],
            cmds["payload"][b, 0], K=2)
        got = sp_recon.prepare_bc(cmds["bts"][b, 0], cmds["mv"][b, 0],
                                  cmds["rect"][b, 0], cmds["payload"][b, 0],
                                  K=2)
        for a, v in zip(bc, got):
            a[b, 0] = v
    init = np.zeros((B, 1, Y, X), np.uint32)
    check(make_sp_decode_step_kmv(mesh, cfg)(
        init, pcs, mvks, cmds["changed"])[:, 0], "kmv")
    check(make_sp_decode_step_bc(mesh, cfg)(
        init, *bc, cmds["changed"])[:, 0], "bc", 0x00FFFFFF)

    # the lane-container ingest over the same mesh: host prep on every
    # process, each holding the streams it owns
    keys = [t == 0 for t in range(T)]
    conts = [transcode_to_lane(
        mux_avi(streams[b], X, Y, 24, codec="SPV4", keyflags=keys),
        window=T, K=2) for b in range(B)]
    pipe = VideoIngestPipeline(
        [MemorySource(c) for c in conts],
        IngestConfig(sp_device_path="lane", mesh=mesh,
                     emit_model_input=False, device="cpu"))
    windows = list(pipe)
    assert len(windows) == 1
    check(windows[0]["frames_u32"], "lane", 0x00FFFFFF)

    # the collective: each process's count of changed frames, all-reduced
    total = mesh.psum([torch.from_numpy(cmds["changed"][rows]).sum()])
    assert int(total) == int(cmds["changed"].sum()), int(total)
    print(f"MULTIHOST_OK proc={pid} slots={mesh.devices.size} "
          f"checked={len(rows)}", flush=True)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()

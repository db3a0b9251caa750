"""The port's checkpoint/resume (jsplayer_tpu_torch.pipeline.checkpoint,
with its Manager, Player and native batch decoder) against the JAX
package's, on the CPU: twins of tests/test_checkpoint.py, each run through
both packages on the same bytes and held equal."""

import dataclasses

import numpy as np
import pytest

from jsplayer_tpu import native as JN
from jsplayer_tpu.core.source import MemorySource as JMem
from jsplayer_tpu.encode.avi_mux import mux_avi
from jsplayer_tpu.encode.sp_enc import ScreenPressorEncoder, pack_rgb
from jsplayer_tpu.pipeline import checkpoint as JC
from jsplayer_tpu.pipeline.ingest import IngestConfig as JCfg
from jsplayer_tpu.pipeline.ingest import VideoIngestPipeline as JPipe
from jsplayer_tpu.player import Player as JPlayer
from jsplayer_tpu.player import PlayerConfig as JConfig
from jsplayer_tpu_torch import native as PN
from jsplayer_tpu_torch.core.source import MemorySource as PMem
from jsplayer_tpu_torch.device import torch_to_u32
from jsplayer_tpu_torch.pipeline import checkpoint as PC
from jsplayer_tpu_torch.pipeline.ingest import IngestConfig as PCfg
from jsplayer_tpu_torch.pipeline.ingest import VideoIngestPipeline as PPipe
from jsplayer_tpu_torch.player import Player as PPlayer
from jsplayer_tpu_torch.player import PlayerConfig as PConfig
from test_checkpoint import X, Y, make_avi


def drive_until_shown(p, max_ticks=500):
    """test_player.drive_until_shown for a Player of either package (each
    has its own FrameResult enum)."""
    for _ in range(max_ticks):
        if p.tick().value == "decompressed" and p.first_shown:
            return True
    return False


def cursors(mod):
    return [mod.StreamCursor("s0", 10, 8, 12345, gop_index=2),
            mod.StreamCursor("s1", 3, 0, 0)]


def test_checkpoint_json_matches_reference(tmp_path):
    """to_json writes the reference's text; each package reads the
    other's file back to equal fields."""
    kw = dict(width=X, height=Y, codec="screenpressor")
    jc = JC.PipelineCheckpoint(cursors=cursors(JC), **kw)
    pc = PC.PipelineCheckpoint(cursors=cursors(PC), **kw)
    assert pc.to_json() == jc.to_json()
    jc.save(str(tmp_path / "j.json"))
    pc.save(str(tmp_path / "p.json"))
    assert (tmp_path / "p.json").read_text() == \
        (tmp_path / "j.json").read_text()
    back = PC.PipelineCheckpoint.load(str(tmp_path / "j.json"))
    assert dataclasses.asdict(back) == dataclasses.asdict(
        JC.PipelineCheckpoint.load(str(tmp_path / "p.json")))
    assert back.cursors[0].restart_point() == (8, 12345)


@pytest.mark.parametrize("indexed", [False, True])
def test_manager_checkpoint_resume_matches_reference(indexed):
    """Both Players seek into GOP 2 and checkpoint (equal cursors); fresh
    Players resume from the cursor and present frame 10, equal to the
    source frame and to each other."""
    avi, frames_px = make_avi()
    got = []
    for P, Cfg, Mem, C in ((JPlayer, JConfig, JMem, JC),
                           (PPlayer, PConfig, PMem, PC)):
        p = P(Cfg(indexed=indexed))
        p.load(Mem(avi))
        assert drive_until_shown(p)
        fps = p.manager.fps
        p.seek_time(10 / fps + 0.001)
        for _ in range(300):
            p.tick()
            if p.manager.last_frame_drawn == 10:
                break
        cur = C.checkpoint_from_loader("s0", p.manager.loader, p.manager)
        p2 = P(Cfg(indexed=indexed))
        p2.load(Mem(avi))
        assert drive_until_shown(p2)
        C.resume_manager(p2.manager, cur)
        state = (p2.manager.next_frame_to_decode,
                 p2.manager.frame_of_interest,
                 [dataclasses.asdict(b) for b in p2.manager.bufs])
        p2.seek_time(10 / fps + 0.001)
        for _ in range(300):
            p2.tick()
            if p2.manager.last_frame_drawn == 10:
                break
        got.append((dataclasses.asdict(cur), state,
                    p2.manager.buffers[p2.manager._last_filled_buffer].copy()))
    (jcur, jstate, jbuf), (pcur, pstate, pbuf) = got
    assert pcur == jcur and pstate == jstate
    assert pcur["keyframe"] % 4 == 0 and pcur["next_frame"] >= 10
    np.testing.assert_array_equal(pbuf, jbuf)
    np.testing.assert_array_equal(pbuf, frames_px[10])


def test_batch_decode_quarantine_matches_reference():
    """A stream with a corrupt P-frame beside a good one: the port's
    native batch decoder gives the reference's arrays, the good stream
    decoded."""
    enc = ScreenPressorEncoder(4, X, Y)
    f0 = np.full(X * Y, pack_rgb(1, 2, 3), dtype=np.uint32)
    good = [enc.encode_i(f0)]
    f1 = f0.copy().reshape(Y, X)
    f1[4:8, 4:8] = pack_rgb(9, 9, 9)
    good.append(enc.encode_p(f1.reshape(-1)))
    bad = [good[0], good[1][:1] + b"\xff" * 40, good[1]]
    good3 = [good[0], good[1], good[1]]
    want = JN.native_sp_decode_streams([good3, bad], X, Y)
    got = PN.native_sp_decode_streams([good3, bad], X, Y)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(got["payload"][0, 1].reshape(-1),
                                  f1.reshape(-1))


def test_ingest_resume_via_frame_range_matches_reference():
    """A cursor restored from the reference's JSON drives the port's
    pipeline through IngestConfig.frame_range: it rewinds to the same
    keyframe and decodes the reference's frames, equal to the source."""
    rng = np.random.default_rng(6)
    enc = ScreenPressorEncoder(4, X, Y)
    f = np.full((Y, X), pack_rgb(6, 6, 6), dtype=np.uint32)
    streams, golds = [], []
    for t in range(14):
        f = f.copy()
        f[(t % 7) * 4: (t % 7) * 4 + 4, 2:30] = pack_rgb(
            *rng.integers(0, 256, 3))
        flat = f.reshape(-1)
        streams.append(enc.encode_i(flat) if t % 5 == 0
                       else enc.encode_p(flat))
        golds.append(flat)
    avi = mux_avi(streams, X, Y, 24, codec="SPV4",
                  keyflags=[t % 5 == 0 for t in range(14)])
    blob = JC.PipelineCheckpoint(cursors=[JC.StreamCursor(
        stream_id="s0", next_frame=8, keyframe=5, byte_offset=0)],
        width=X, height=Y, codec="screenpressor").to_json()
    cur = PC.PipelineCheckpoint.from_json(blob).cursors[0]
    rng_ = (cur.next_frame, len(streams))
    want = {b["start_frame"]: np.asarray(b["frames_u32"]) for b in JPipe(
        [JMem(avi)], JCfg(window=4, frame_range=rng_))}
    got = {b["start_frame"]: torch_to_u32(b["frames_u32"]) for b in PPipe(
        [PMem(avi)], PCfg(window=4, frame_range=rng_, device="cpu"))}
    assert sorted(got) == sorted(want) and min(got) == cur.keyframe
    for s in want:
        np.testing.assert_array_equal(got[s], want[s])
        for t in range(got[s].shape[1]):
            if s + t < len(golds):
                np.testing.assert_array_equal(got[s][0, t].reshape(-1),
                                              golds[s + t])

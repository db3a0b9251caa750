"""A palettized codec and an MP3 track through the harness, at a tiny size
on the CPU: an 8-bit MSVideo1 configuration with audio, written into a copy
of the tiny checkout (the repo's BENCHMARK.json does not name it).  The
container parses back, by a plain RIFF walk, to the palette and to the
synthesized MP3 frames in their chunks; the port decodes the stream to
PALETTE[indices]; a whole run is `correct` with no audio frame wrong; and
each fault of the track, the control's video-clock times among them,
turns `correct` false."""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import struct
import time

import numpy as np
import pytest
import torch

from portbench.harness import run_cell
from portbench.spec import CHECKOUT, Bench

CELL = "msv1_qvga8_mp3_desktop"
AUDIO = {"format": "mp3", "bitrate_kbps": 128, "sample_rate": 44100,
         "channels": 2}


def _add_cell(co: str, reference: str = "ds2_frames_mp3") -> None:
    """The 8-bit configuration with audio, its mix and its cell, written
    into checkout `co` (the tiny sizes of msv1_qvga16_b8 and its mix)."""
    root = os.path.join(co, "portbench")
    with open(os.path.join(root, "configs", "msv1_qvga16_b8.json")) as f:
        c = json.load(f)
    c.update(name="msv1_qvga8_mp3_b8", codec="msv1_8", bpp=8,
             reference=reference, audio=AUDIO)
    c["control"] = dict(c["control"], pixel_mask="0xF8FCF8")
    with open(os.path.join(root, "configs", "msv1_qvga8_mp3_b8.json"),
              "w") as f:
        json.dump(c, f)
    with open(os.path.join(root, "traffic", "msv1_desktop.json")) as f:
        t = json.load(f)
    t["recipe_params"] = {"bits": 8}
    with open(os.path.join(root, "traffic", "msv1_desktop8.json"), "w") as f:
        json.dump(t, f)
    with open(os.path.join(co, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["configs"].append({"name": "msv1_qvga8_mp3_b8", "source": "a test",
                            "file": "portbench/configs/msv1_qvga8_mp3_b8.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": CELL, "config": "msv1_qvga8_mp3_b8",
                              "traffic": "msv1_desktop8", "chips": 1,
                              "why": "a test"})
    with open(os.path.join(co, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)


@pytest.fixture(scope="module")
def av_checkout(tiny_checkout, tmp_path_factory):
    co = str(tmp_path_factory.mktemp("av") / "co")
    shutil.copytree(tiny_checkout, co)
    _add_cell(co)
    return co


@pytest.fixture(scope="module")
def av_inputs(av_checkout):
    from portbench.inputs import make_inputs

    cell = Bench(av_checkout).cell(CELL)
    return cell, make_inputs(cell, 2**31 + 5)


def _riff(data: bytes, at: int = 0, end: int = None):
    """(fourcc, payload) of each chunk in data[at:end], LIST payloads with
    their list type first."""
    end = len(data) if end is None else end
    while at + 8 <= end:
        tag, n = struct.unpack_from("<4sI", data, at)
        yield tag, data[at + 8:at + 8 + n]
        at += 8 + n + (n & 1)


def _walk(avi: bytes) -> tuple:
    """(strf payloads in stream order, the movi chunks in order)."""
    (tag, body), = list(_riff(avi))
    assert tag == b"RIFF" and body[:4] == b"AVI "
    strf, movi = [], None
    for tag, pay in _riff(body, 4):
        if tag == b"LIST" and pay[:4] == b"hdrl":
            for t2, p2 in _riff(pay, 4):
                if t2 == b"LIST" and p2[:4] == b"strl":
                    strf += [p3 for t3, p3 in _riff(p2, 4) if t3 == b"strf"]
        elif tag == b"LIST" and pay[:4] == b"movi":
            movi = list(_riff(pay, 4))
    return strf, movi


def _mp3_frames(data: bytes) -> list:
    """Split MPEG-1 Layer III frames by their headers alone (ISO/IEC
    11172-3: 144 * bitrate / rate bytes, plus the padding byte)."""
    rates = {0: 44100, 1: 48000, 2: 32000}
    kbps = [0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320]
    out, at = [], 0
    while at < len(data):
        h = int.from_bytes(data[at:at + 4], "big")
        assert h >> 21 == 0x7FF and (h >> 19) & 3 == 3 and (h >> 17) & 3 == 1
        n = 144000 * kbps[(h >> 12) & 15] // rates[(h >> 10) & 3] + (
            (h >> 9) & 1)
        out.append(data[at:at + n])
        at += n
    assert at == len(data)
    return out


def test_container_holds_the_palette_and_the_mp3_frames(av_inputs):
    """Each stream's AVI, walked chunk by chunk: strf's palette is
    PALETTE, and after video frame t one 01wb chunk holds exactly the
    track's frames whose first sample falls in [t/15, (t+1)/15) s."""
    from portbench.encode import msv1_8

    cell, inp = av_inputs
    T, rate = cell.config["frames"], AUDIO["sample_rate"]
    for avi, track in zip(inp.containers, inp.audio):
        strf, movi = _walk(avi)
        vids, auds = strf
        assert struct.unpack_from("<HI", vids, 14) == (8, 0x4D415243)
        assert struct.unpack_from("<I", vids, 32)[0] == 256
        assert vids[40:] == msv1_8.PALETTE.astype("<u4").tobytes()
        assert struct.unpack("<HHIIHH", auds) == (0x55, 2, rate, 16000, 1, 0)
        n = -(-T * rate // (15 * 1152))
        assert len(track) == n == len(_mp3_frames(b"".join(track)))
        want: dict = {}
        for k, f in enumerate(track):
            want.setdefault(k * 1152 * 15 // rate, []).append(f)
        t, got = -1, {}
        for tag, pay in movi:
            if tag == b"00dc":
                t += 1
            else:
                assert tag == b"01wb" and t not in got
                got[t] = _mp3_frames(pay)
        assert t == T - 1 and got == want


def test_mp3_frames_hold_the_bitrate():
    """128 frames of video at 15 frames/s: 327 frames of 417 and 418
    bytes, the padding bit set on exactly the 418-byte ones, and frames
    0..i-1 together floor(i * 144 * 128000 / 44100) bytes."""
    from portbench.encode import mp3

    frames, chunks = mp3.track(3, 128, 15.0, **{k: v for k, v in
                                                AUDIO.items()
                                                if k != "format"})
    assert len(frames) == 327 and len(chunks) == 128
    assert {len(f) for f in frames} == {417, 418}
    for f in frames:
        assert (f[2] >> 1) & 1 == len(f) - 417
    total = np.cumsum([len(f) for f in frames])
    assert all(total[i - 1] == i * 144 * 128000 // 44100
               for i in range(1, 328))


def test_8bit_encoder_is_the_ports():
    from jsplayer_tpu_torch.encode.msv1_enc import encode_frame_8
    from portbench.encode.msv1_enc8 import encode_frame_8 as frozen

    rec = Bench(CHECKOUT).module("recipes", "msv1_desktop")
    f = rec.frames(9, 6, 48, 64, bits=8).reshape(6, -1)
    for t in range(6):
        prev = f[t - 1] if t else None
        assert frozen(f[t], prev, 64, 48) == encode_frame_8(f[t], prev, 64,
                                                            48)


def test_port_decodes_to_palette_colours(av_inputs):
    """The port's pipeline decodes one tiny 8-bit stream to
    PALETTE[indices], frame for frame."""
    from jsplayer_tpu_torch import (IngestConfig, MemorySource,
                                    VideoIngestPipeline)
    from portbench.encode import msv1_8

    cell, inp = av_inputs
    rec = cell.bench.module("recipes", "msv1_desktop")
    period = cell.traffic["period"]
    idx = rec.frames(cell.traffic["pool_seeds"][inp.pool[0]], period,
                     cell.config["height"], cell.config["width"], bits=8)
    T = cell.config["frames"]
    want = msv1_8.PALETTE[np.concatenate([idx] * (-(-T // period)))[:T]]
    assert np.array_equal(want, inp.frames[0])
    pipe = VideoIngestPipeline([MemorySource(inp.containers[0])],
                               IngestConfig(window=8, device="cpu"))
    got = np.concatenate([w["frames_u32"][0].numpy().view(np.uint32)
                          for w in pipe])
    assert np.array_equal(got & 0xFFFFFF, want)


def test_run_is_correct_with_no_audio_frame_wrong(av_checkout):
    cell = Bench(av_checkout).cell(CELL)
    with torch.no_grad():
        res = run_cell(cell, 2**31 + 9, 0.3, False, "cpu",
                       time.perf_counter())
    assert res["correct"], res["checks"]
    assert res["checks"]["audio_frames_wrong"] == {"value": 0, "limit": 0}
    assert res["window"]["passes"] >= 2


def _drop_frame(sec):
    """The section less its middle frame (the port's SoundSection)."""
    sizes = [len(f) for f in _mp3_frames(sec.data)]
    j = len(sizes) // 2
    a = sum(sizes[:j])
    return dataclasses.replace(sec, data=sec.data[:a] + sec.data[a + sizes[j]:],
                               nframes=sec.nframes - 1)


FAULTS = {
    "frame_dropped": _drop_frame,
    "shifted_one_frame": lambda sec: dataclasses.replace(
        sec, start_time=sec.start_time + 1152 / sec.sample_rate),
    "byte_altered": lambda sec: dataclasses.replace(
        sec, data=sec.data[:len(sec.data) // 2]
        + bytes([sec.data[len(sec.data) // 2] ^ 1])
        + sec.data[len(sec.data) // 2 + 1:]),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_audio_fault_is_caught(av_checkout, monkeypatch, fault):
    """The fault planted where the port's demux hands a section to one
    stream's track (the first stream of every pipeline)."""
    from jsplayer_tpu_torch.av import audio_track

    cell = Bench(av_checkout).cell(CELL)
    B = cell.config["streams"]
    raw_init, raw_add = (audio_track.AudioTrack.__init__,
                         audio_track.AudioTrack.add_section)
    made = iter(range(1 << 30))

    def init(self):
        raw_init(self)
        self.serial = next(made)

    def add_section(self, sec):
        return raw_add(self, FAULTS[fault](sec) if self.serial % B == 0
                       else sec)

    monkeypatch.setattr(audio_track.AudioTrack, "__init__", init)
    monkeypatch.setattr(audio_track.AudioTrack, "add_section", add_section)
    with torch.no_grad():
        res = run_cell(cell, 2**31 + 13, 0.3, False, "cpu",
                       time.perf_counter())
    assert res["correct"] is False
    assert res["checks"]["audio_frames_wrong"]["value"] > 0
    assert res["checks"]["frame_px_wrong"]["value"] == 0


def test_control_times_are_caught(av_inputs):
    """The control's sections (each chunk at its video frame's time) are
    not correct; the exact sections (the whole track from 0) are."""
    from portbench.inputs import FPS
    from portbench.judge import Judge

    cell, inp = av_inputs
    ref = cell.bench.module("references", "ds2_frames_mp3")
    ctl = Judge(inp.frames, cell.config, ref, "cpu", audio=inp.audio)
    ctl.audio([ref.control_audio(a, AUDIO, FPS) for a in inp.audio])
    assert not ctl.correct()
    assert ctl.checks()["audio_frames_wrong"]["value"] > 0
    exact = Judge(inp.frames, cell.config, ref, "cpu", audio=inp.audio)
    exact.audio([[ref.Section(0.0, len(a) * 1152 / 44100, b"".join(a))]
                 for a in inp.audio])
    exact.audio([[ref.Section(0.0, 1152 * 2 / 44100, b"".join(a[:2])),
                  ref.Section(1152 * 2 / 44100, (len(a) - 2) * 1152 / 44100,
                              b"".join(a[2:]))] for a in inp.audio])
    assert exact.correct(), exact.checks()
    exact.audio(None)  # a pass that kept no track
    assert exact.checks()["audio_frames_wrong"]["value"] == sum(
        len(a) for a in inp.audio)


def test_readings_give_the_audio_count(av_checkout, capsys):
    from portbench import readings

    assert readings.main(["--workload", CELL, "--seconds", "0.1",
                          "--seeds", "4", "--control-seeds", "4",
                          "--device", "cpu", "--checkout", av_checkout]) == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert lines[0]["correct"] and not lines[0]["control_correct"]
    assert lines[-1]["program_max"] == {"frame_px_wrong": 0,
                                        "model_elems_wrong": 0,
                                        "audio_frames_wrong": 0}
    assert min(lines[-1]["control_min"].values()) > 0


def test_audio_without_an_audio_reference_is_refused(tiny_checkout,
                                                     tmp_path):
    co = str(tmp_path / "co")
    shutil.copytree(tiny_checkout, co)
    _add_cell(co, reference="ds2_frames")
    with pytest.raises(ValueError, match="audio_frames_wrong"):
        Bench(co).cell(CELL)

"""The plain reference of a deployment with an MP3 track beside its video.

The video is judged as ``ds2_frames`` judges it: its pixel mask, model
epilogue and control are that module's, loaded beside this one.  The
audio is passed through, so an MP3 frame is judged by its bytes and its
time: each section of a stream's audio track has to start exactly on the
sample where its first frame begins (frame k at k x 1152 / sample_rate s,
the PTS model of MPEG-1 Layer III), last its frames' samples and hold
their bytes; every source frame has to be delivered so (judge.py,
``audio_frames_wrong``).  Passthrough is exact: the limit is 0.

``control_audio`` is the audio one precision below: the container's
``01wb`` chunks as sections, each stamped with the time of the video frame
it follows (t / fps, the sample-exact start rounded down to the video
frame grid), as a demuxer that times audio by the video clock delivers
them.  It has to fail.
"""

from __future__ import annotations

import importlib.util
import os
from collections import namedtuple
from fractions import Fraction

SAMPLES = 1152


def _sibling(name: str):
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_references_{name}_of_mp3", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_video = _sibling("ds2_frames")
PIXEL_MASK = _video.PIXEL_MASK
model = _video.model
control = _video.control
LIMITS = {**_video.LIMITS, "audio_frames_wrong": 0}


Section = namedtuple("Section", "start_time duration data")  # seconds, bytes


def control_audio(frames: list, audio: dict, fps: float) -> list:
    """The control's sections of one stream's track `frames` (each frame's
    bytes, in order) under the configuration's `audio`, its video at
    `fps`: one section a chunk, at its video frame's time."""
    rate, fps = audio["sample_rate"], Fraction(fps)
    chunks: dict = {}
    for k, f in enumerate(frames):
        chunks.setdefault(int(k * SAMPLES * fps // rate), []).append(f)
    return [Section(float(t / fps), len(fs) * SAMPLES / rate, b"".join(fs))
            for t, fs in sorted(chunks.items())]

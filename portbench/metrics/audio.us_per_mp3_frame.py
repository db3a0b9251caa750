"""Host us an MP3 frame of the port's jsp.audio span, self time: its
seconds over the port's audio.frames counter, the MP3 frames its parsing
handed to the streams' audio tracks; None where either is missing
(portbench/program.py)."""

from portbench.program import counter, summary

SPANS = []
COUNTERS = []


def read(ctx):
    s = summary()
    seconds = None if s is None else s["self_s"].get("jsp.audio")
    frames = counter("audio.frames")
    if seconds is None or not frames:
        return None
    return 1e6 * seconds / frames

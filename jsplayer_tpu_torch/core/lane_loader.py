"""DataLoader for `.jlv` lane containers — the Player's third source kind.

The lane container (codecs/lane_format) is this framework's own serving
format; the reference only ever plays AVIs, but a user who transcoded
their archive to lane containers still wants the interactive Player
(seek/skip-stills/thumbnail/audio — the whole Main.hx surface).  This
loader adapts a parsed container to the DataLoader contract
(DataLoader.hx:24-430): every frame is READY at open (containers are
meta-deflated and small — bench corpus ~80 KB — so whole-blob load
replaces the AVI path's progressive XHR), frame "chunks" are 4-byte
frame indices decoded by codecs.lane_host.LaneHostCodec, keyframes are
restart-window leads, and the per-frame significance verdicts ship IN
the container, so skip-stills (Manager.hx:289-317) never has to decode
ahead to classify a frame.
"""

from __future__ import annotations

from typing import Callable, Optional

from ..codecs import lane_format
from ..codecs.lane_host import LaneHostCodec
from .loader import DataLoader
from .source import ByteSource
from .types import CodecType, CompressedFrame, VideoInfo


class LaneDataLoader(DataLoader):
    def __init__(self) -> None:
        super().__init__()
        self.container: Optional[lane_format.LaneContainer] = None

    def open(self, source: ByteSource,
             on_video_info: Optional[Callable[[VideoInfo], None]] = None
             ) -> None:
        self._video_info_cb = on_video_info
        cont = lane_format.container_from_bytes(source.read_range(0))
        self.container = cont
        vi = VideoInfo(width=cont.X, height=cont.Y, bpp=cont.bpp,
                       fps=cont.fps, nframes=cont.n_frames,
                       codec=CodecType.LANE)
        self._on_video_info(vi)
        t = 0
        for w in cont.windows:
            for lt in range(w.T):
                self.frames[t] = CompressedFrame(
                    key=(w.restart and lt == 0),
                    data=LaneHostCodec.frame_chunk(t),
                    significant_changes=bool(w.signif[lt]))
                t += 1
        if cont.audio:
            self.sound_buffer.add_chunk(cont.audio)
        self.mp3_parser.on_data_end()  # the blob is all the sound there is

    def make_decoder(self, vi: VideoInfo) -> LaneHostCodec:
        """Loader-supplied decoder factory (the Manager prefers this over
        pipeline.manager.make_decoder when present): the lane codec needs
        the parsed container, which only this loader holds."""
        assert self.container is not None
        return LaneHostCodec(self.container)

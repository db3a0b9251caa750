"""VideoCodec adapter over the native C++ ScreenPressor decoder.

Drop-in replacement for codecs.screenpressor.ScreenPressor in the Manager's
ring-buffer protocol (IVideoCodec surface, IVideoCodec.hx:16-29): decoded
pixels are copied into the caller's ring buffer and ``previous_frame``
identity tracks which ring buffer holds the latest frame, so the Manager's
no-change buffer-extension logic (Manager.hx:515-524) keeps working.

The batch pipeline bypasses this adapter and uses the zero-copy native API
directly (pipeline/batch.stack_sp_commands).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .. import native
from .base import DecoderState, PFrameResult, VideoCodec


class NativeScreenPressorCodec(VideoCodec):
    def __init__(self, width: int, height: int, bits_per_pixel: int = 24):
        self._n = native.NativeScreenPressor(width, height, bits_per_pixel)
        self._prev: Optional[np.ndarray] = None  # the ring buffer holding it

    def preinit(self, insignificant_lines: int) -> None:
        self._n.preinit(insignificant_lines)

    def previous_frame(self) -> Optional[np.ndarray]:
        return self._prev

    def is_key_frame(self, data: bytes) -> bool:
        return self._n.is_key_frame(data)

    def needs_index(self) -> bool:
        return False

    def decompress_i(self, src: bytes, dst: np.ndarray) -> DecoderState:
        try:
            view, _sig, _ = self._n.decompress(src, True, copy=False)
        except ValueError:
            return DecoderState.ERROR
        if view is None:
            return DecoderState.ERROR
        np.copyto(dst, view)
        self._prev = dst
        return DecoderState.ZERO

    def decompress_p(self, src: bytes, dst: np.ndarray) -> PFrameResult:
        try:
            view, sig, _ = self._n.decompress(src, False, copy=False)
        except ValueError:
            return PFrameResult(self._prev, False)
        if view is None:  # no change
            return PFrameResult(self._prev, sig)
        np.copyto(dst, view)
        self._prev = dst
        return PFrameResult(dst, sig)


class NativeMsv1Codec(VideoCodec):
    """VideoCodec adapter over the native MSVideo1 decoder (8/16-bit)."""

    def __init__(self, width: int, height: int,
                 palette: Optional[bytes] = None):
        pal = None
        if palette is not None:
            pal = np.zeros(256, dtype=np.uint32)
            n = min(256, len(palette) // 4)
            if n:
                pal[:n] = np.frombuffer(palette[: n * 4], dtype="<u4")
        self._n = native.NativeMsv1(width, height, palette=pal)
        self._prev: Optional[np.ndarray] = None

    def preinit(self, insignificant_lines: int) -> None:
        self._n.preinit(insignificant_lines)

    def previous_frame(self) -> Optional[np.ndarray]:
        return self._prev

    def is_key_frame(self, data: bytes) -> bool:
        # keyframe probing stays with the (cheap) oracle scan — the native
        # decoder only paints; reuse the python implementation
        from .msvideo1 import MSVideo1_8bit, MSVideo1_16bit

        if getattr(self, "_probe", None) is None:
            if self._n._pal is not None:
                self._probe = MSVideo1_8bit(self._n.X, self._n.Y,
                                            self._n._pal.astype("<u4").tobytes())
            else:
                self._probe = MSVideo1_16bit(self._n.X, self._n.Y)
        return self._probe.is_key_frame(data)

    def needs_index(self) -> bool:
        return True

    def decompress_i(self, src: bytes, dst: np.ndarray) -> DecoderState:
        self.decompress_p(src, dst)
        return DecoderState.ZERO

    def decompress_p(self, src: bytes, dst: np.ndarray) -> PFrameResult:
        view, sig = self._n.decompress(src, copy=False)
        if view is None:
            return PFrameResult(self._prev, sig)
        np.copyto(dst, view)
        self._prev = dst
        return PFrameResult(dst, sig)

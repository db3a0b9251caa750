"""Video codec interface.

Parity with IVideoCodec (IVideoCodec.hx:16-29), restated for a host/device
split: decoders decode into caller-provided uint32 numpy frame buffers
(the Manager's Int32Array ring, Manager.hx:114-119) and report the
previous-frame pointer + significant-change verdict (PFrameResult,
IVideoCodec.hx:11-14).  The incremental-I-frame state machine
(DecoderState, IVideoCodec.hx:5-9) is kept for API parity; on TPU an I-frame
decodes in one shot so ``State()`` is always ZERO.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional

import numpy as np


class DecoderState(enum.Enum):
    ZERO = "zero_state"
    IN_PROGRESS = "in_progress"
    ERROR = "error_occured"


@dataclass
class PFrameResult:
    """IVideoCodec.hx:11-14: pointer to decoded data + change flag."""

    data: Optional[np.ndarray]  # the decoded frame (dst buffer or prev frame)
    significant_changes: bool


class VideoCodec:
    """IVideoCodec contract (IVideoCodec.hx:16-29)."""

    def preinit(self, insignificant_lines: int) -> None:
        raise NotImplementedError

    def previous_frame(self) -> Optional[np.ndarray]:
        raise NotImplementedError

    def is_key_frame(self, data: bytes) -> bool:
        raise NotImplementedError

    def state(self) -> DecoderState:
        return DecoderState.ZERO

    def decompress_i(self, src: bytes, dst: np.ndarray) -> DecoderState:
        raise NotImplementedError

    def continue_i(self) -> DecoderState:
        return DecoderState.ZERO

    def decompress_p(self, src: bytes, dst: np.ndarray) -> PFrameResult:
        raise NotImplementedError

    def needs_index(self) -> bool:
        raise NotImplementedError

    def stop_and_clean(self) -> None:
        pass

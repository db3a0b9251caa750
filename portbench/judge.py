"""Decide `correct`: the delivered windows against the plain reference.

A window dict is judged slot by slot on the stream timeline it covers
(``start_frame`` on, as many slots as the stream has frames left).  A
dense window holds ``frames_u32`` / ``model_input`` [B, n, ...]; an elided
one a flat row stack and ``outmap`` [B, n], where -1 stands for the
window's carry-in frame: the stream's frame before the window (the zero
frame before frame 0), which the source frame of that slot must then
equal.  Each window can so be judged alone, and a whole pass besides by
whether its windows cover every frame of the streams.  The counts:

  frame_px_wrong      pixels whose 24 bits differ from the source frame;
                      every pixel of a slot whose row is missing (outmap
                      past the stack) and of a frame a whole pass left out
  model_elems_wrong   model tensor elements whose bits differ from the
                      reference epilogue of the source frame

Each has the limit its reference module's LIMITS gives.
"""

from __future__ import annotations

import numpy as np
import torch

_INT_OF = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(_INT_OF[t.element_size()])


def slots(w: dict, T: int) -> int:
    """Timeline frames a window delivers for each stream."""
    if w.get("outmap") is not None:
        n = np.asarray(w["outmap"]).shape[1]
    elif "frames_u32" in w:
        n = w["frames_u32"].shape[1]
    else:
        n = w["model_input"].shape[1]
    return max(0, min(n, T - int(w["start_frame"])))


class Judge:
    """Counts over every window handed to `window`, against source frames
    [B] of [T, Y, X] u32 and a reference module (references/<name>.py)."""

    def __init__(self, frames: list, cfg: dict, reference, device):
        self.frames, self.cfg, self.ref = frames, cfg, reference
        self.device = torch.device(device)
        self.counts = {k: 0 for k in reference.LIMITS}
        self.windows = 0

    def _src(self, b: int, lo: int, hi: int) -> torch.Tensor:
        a = self.frames[b][lo:hi].view(np.int32)
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _compare(self, got_f, got_m, src) -> None:
        mask = self.ref.PIXEL_MASK
        if got_f is not None:
            if got_f.shape != src.shape:
                self.counts["frame_px_wrong"] += src.numel()
            else:
                self.counts["frame_px_wrong"] += int(
                    (((got_f ^ src) & mask) != 0).sum())
        if got_m is not None:
            want = self.ref.model(src, self.cfg)
            if got_m.shape != want.shape or got_m.dtype != want.dtype:
                self.counts["model_elems_wrong"] += want.numel()
            else:
                self.counts["model_elems_wrong"] += int(
                    (_bits(got_m) != _bits(want)).sum())

    def window(self, w: dict, T: int) -> None:
        start, n = int(w["start_frame"]), slots(w, T)
        frames, model = w.get("frames_u32"), w.get("model_input")
        om = w.get("outmap")
        self.windows += 1
        for b in range(len(self.frames)):
            src = self._src(b, start, start + n)
            if om is None:
                self._compare(None if frames is None else frames[b, :n],
                              None if model is None else model[b, :n], src)
                continue
            idx = np.asarray(om)[b, :n].astype(np.int64)
            nrows = (frames if frames is not None else model).shape[0]
            bad = idx >= nrows
            self.counts["frame_px_wrong"] += int(bad.sum()) * src[0].numel()
            rows = np.nonzero((idx >= 0) & ~bad)[0]
            if len(rows):
                sel = torch.from_numpy(idx[rows]).to(self.device)
                keep = torch.from_numpy(rows).to(self.device)
                self._compare(None if frames is None else frames[sel],
                              None if model is None else model[sel],
                              src[keep])
            carried = np.nonzero(idx < 0)[0]
            if len(carried):
                # the slot repeats the carry-in frame: the source must too
                prev = (self._src(b, start - 1, start) if start else
                        torch.zeros_like(src[:1]))
                self.counts["frame_px_wrong"] += int(
                    (((src[torch.from_numpy(carried).to(self.device)]
                       ^ prev) & self.ref.PIXEL_MASK) != 0).sum())

    def coverage(self, windows: list, T: int) -> None:
        """A whole pass's windows must cover frames [0, T) of every
        stream: each frame left out counts all its pixels wrong."""
        seen = np.zeros(T, dtype=bool)
        for w in windows:
            s = int(w["start_frame"])
            seen[s:s + slots(w, T)] = True
        Y, X = self.frames[0].shape[1:]
        self.counts["frame_px_wrong"] += (int((~seen).sum()) * Y * X
                                          * len(self.frames))

    def checks(self) -> dict:
        """{name: {"value": count, "limit": limit}}."""
        return {k: {"value": v, "limit": self.ref.LIMITS[k]}
                for k, v in self.counts.items()}

    def correct(self) -> bool:
        return all(v <= self.ref.LIMITS[k] for k, v in self.counts.items())


def control_windows(frames: list, cfg: dict, reference, device,
                    window: int):
    """Dense windows [B, n, ...] of the reference's control over one pass
    of the source frames, as the program's windows would come."""
    T = frames[0].shape[0]
    for start in range(0, T, window):
        got_f, got_m = [], []
        for f in frames:
            src = torch.from_numpy(np.ascontiguousarray(
                f[start:start + window].view(np.int32))).to(device)
            cf, cm = reference.control(src, cfg)
            got_f.append(cf)
            got_m.append(cm)
        yield {"start_frame": start, "frames_u32": torch.stack(got_f),
               "model_input": torch.stack(got_m)}

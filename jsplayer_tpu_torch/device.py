"""Device selection and u32-plane helpers.

Decoded frames and kmv paycode planes are u32 words.  torch's ``uint32``
has thin operator coverage (no ``>>`` or ``>`` on the CPU), so the port
keeps every plane as a ``torch.int32`` tensor holding the SAME bits: numpy
``u32.view(np.int32)`` on the way in, ``.view(np.uint32)`` on the way out.
Every right shift is followed by a mask, which makes the arithmetic shift
exact whatever bit 31 holds.
"""

from __future__ import annotations

import numpy as np
import torch

from .utils.logging import LOG, TRACE


def resolve_device(name) -> torch.device:
    """``"cuda"``/``"cuda:N"``/``"cpu"`` → torch.device.  Asking for CUDA
    where there is none raises: the port never falls back to the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but torch.cuda.is_available() is "
            f"False (torch {torch.__version__}); pass device='cpu' "
            f"explicitly to run the plain versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r}")
    return dev


def torch_to_u32(t: torch.Tensor) -> np.ndarray:
    """int32 tensor of u32 bits → numpy u32 array (copied to host)."""
    if t.dtype != torch.int32:
        raise TypeError(f"expected an int32 bit-view tensor, got {t.dtype}")
    return t.detach().cpu().numpy().view(np.uint32)


def cuda_launch_checks(what: str, *planes: torch.Tensor) -> None:
    """A kernel wrapper's guard for its non-CPU branch: every plane is an
    int32 bit view on one CUDA device.  Anything else raises — a tensor
    that is not on the CPU never takes the plain version."""
    dev = planes[0].device
    for t in planes:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(
                f"{what}: expected tensors on one CUDA device (or all on "
                f"the CPU for the plain version), got {t.device}")
        if t.dtype != torch.int32:
            raise TypeError(f"{what}: expected int32 bit-view planes, got "
                            f"{t.dtype}")


def _host_words(a: np.ndarray) -> torch.Tensor:
    """An upload's source: `a` made contiguous, u32 as int32 bits, wrapped
    without a copy, and counted (``upload.bytes``, ``upload.calls``)."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    LOG.count("upload.bytes", a.nbytes)
    LOG.count("upload.calls")
    return torch.from_numpy(a)


def to_device(a: np.ndarray, device) -> torch.Tensor:
    """Host→device upload of a numpy array (u32 planes become int32 bit
    views).  A blocking copy: the caller may rewrite `a` as soon as this
    returns, which is what lets the pooled host buffers be refilled by the
    next window without an event wait.  Counts ``upload.bytes`` and
    ``upload.calls`` (LOG) and is the ``jsp.upload`` span (TRACE)."""
    with TRACE.span("jsp.upload"):
        return _host_words(a).to(device)


def to_device_into(a: np.ndarray, out: torch.Tensor) -> torch.Tensor:
    """Host→device upload of a numpy array into `out`, a contiguous slice
    of an existing device tensor of `a`'s shape (u32 planes into int32 bit
    views).  Blocking and pageable like to_device, and counted and spanned
    the same way; returns `out`."""
    if tuple(out.shape) != a.shape:
        raise ValueError(f"to_device_into: {a.shape} into {tuple(out.shape)}")
    with TRACE.span("jsp.upload"):
        return out.copy_(_host_words(a))

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


def to_device(a: np.ndarray, device) -> torch.Tensor:
    """Host→device upload of a numpy array (u32 planes become int32 bit
    views).  A blocking copy: the caller may rewrite `a` as soon as this
    returns, which is what lets the pooled host buffers be refilled by the
    next window without an event wait."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(device)

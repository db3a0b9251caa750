"""Device selection and u32-plane helpers.

Decoded frames and kmv paycode planes are u32 words.  torch's ``uint32``
has thin operator coverage (no ``>>`` or ``>`` on the CPU), so the port
keeps every plane as a ``torch.int32`` tensor holding the SAME bits: numpy
``u32.view(np.int32)`` on the way in, ``.view(np.uint32)`` on the way out.
Every right shift is followed by a mask, which makes the arithmetic shift
exact whatever bit 31 holds.
"""

from __future__ import annotations

import ctypes
import mmap
import threading
import weakref

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


# [start, end) byte addresses of the host memory pin_host page-locked
_PINNED: list = []


def _register_host(ptr: int, nbytes: int) -> bool:
    """cudaHostRegister of [ptr, ptr + nbytes), portable (every card of
    the process reads it as pinned), not write-combined (the host reads
    what it wrote there) → whether the pages are now locked."""
    if int(torch.cuda.cudart().cudaHostRegister(ptr, nbytes, 1)) == 0:
        return True
    # the failed call's error would be raised by the next launch check
    ctypes.CDLL(None).cudaGetLastError()
    return False


def _fault_in(a: np.ndarray, threads: int = 8) -> None:
    """Write a word of every page of `a` back unchanged, from `threads`
    threads: the kernel maps fresh pages several at once, where
    cudaHostRegister maps them one after another (8.49 GB: 2.1 s of
    faults and 1.3 s of register, against 5.5 s of register alone, on
    8 cores)."""
    flat = a.reshape(-1).view(np.uint8)
    page = mmap.PAGESIZE
    step = -(-flat.size // threads // page) * page

    def touch(k):
        v = flat[k * step:(k + 1) * step:page]
        v |= 0

    workers = [threading.Thread(target=touch, args=(k,))
               for k in range(threads)]
    for w in workers:
        w.start()
    for w in workers:
        w.join()


def _unregister_host(ptr: int) -> None:
    """cudaHostUnregister of what _register_host locked at `ptr`, once no
    card still copies from it."""
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)
    torch.cuda.cudart().cudaHostUnregister(ptr)


def _unpin(ptr: int, span: tuple, pinned: list, unregister) -> None:
    unregister(ptr)
    pinned.remove(span)


def pin_host(a: np.ndarray) -> bool:
    """Page-lock `a`'s own bytes in place, for the life of `a`, so that
    to_device_into copies from them without blocking the host.  Where the
    lock fails `a` stays pageable, its uploads blocking, and this returns
    False.  `a` owns its memory."""
    ptr = a.__array_interface__["data"][0]
    if a.base is not None or not a.flags.c_contiguous or not a.nbytes or \
            any(ptr < q and p < ptr + a.nbytes for p, q in _PINNED):
        return False
    _fault_in(a)
    if not _register_host(ptr, a.nbytes):
        return False
    span = (ptr, ptr + a.nbytes)
    _PINNED.append(span)
    weakref.finalize(a, _unpin, ptr, span, _PINNED,
                     _unregister_host).atexit = False
    return True


def is_pinned(a: np.ndarray) -> bool:
    """Whether `a` is contiguous in host memory that pin_host locked."""
    lo = a.__array_interface__["data"][0]
    return a.flags.c_contiguous and any(p <= lo and lo + a.nbytes <= q
                                        for p, q in _PINNED)


def upload_guard(device: torch.device) -> torch.cuda.Event:
    """An event recorded on CUDA `device`'s current stream: it passes once
    every copy queued there so far has read its host source, the
    non-blocking ones from pinned pages included."""
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


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
    views).  A blocking copy, pinned pages or not: the caller may rewrite
    `a` as soon as this returns.  Counts ``upload.bytes`` and
    ``upload.calls`` (LOG) and is the ``jsp.upload`` span (TRACE)."""
    with TRACE.span("jsp.upload"):
        return _host_words(a).to(device)


def to_device_into(a: np.ndarray, out: torch.Tensor) -> torch.Tensor:
    """Host→device upload of a numpy array into `out`, a contiguous slice
    of an existing device tensor of `a`'s shape (u32 planes into int32 bit
    views); counted and spanned as to_device; returns `out`.  From pages
    pin_host locked the copy is queued without blocking (and counted in
    ``upload.pinned_bytes``): the caller must not rewrite `a` before an
    upload_guard recorded after it has passed.  From pageable pages it
    blocks, as to_device."""
    if tuple(out.shape) != a.shape:
        raise ValueError(f"to_device_into: {a.shape} into {tuple(out.shape)}")
    with TRACE.span("jsp.upload"):
        pinned = is_pinned(a)
        if pinned:
            LOG.count("upload.pinned_bytes", a.nbytes)
        return out.copy_(_host_words(a), non_blocking=pinned)

"""Pinned pooled planes and the guard of their refill, on the CPU.

A CUDA pipeline page-locks each pooled plane (device.pin_host), copies the
changed rows from it without blocking (device.to_device_into) and records
an event after each window's copies (device.upload_guard) in the pooled
buffer's ``guard``; the next fill of the plane waits on those events
first, in the same pipeline or in the next one to take the buffer from
the pool.  Here the lock and the event are stubs, so the CPU pipeline
takes that very path: every fill comes after the wait on every event
recorded before it, no blocking upload follows a window's pinned copies,
the pool keeps pinned and pageable planes under their own keys, and the
windows equal a plain CPU run's bit for bit (kmv and bc, CONCAT and
PADDED, one device and a dp=2 mesh of CPU slots).
"""

import numpy as np
import pytest
import torch

from jsplayer_tpu_torch import device as D
from jsplayer_tpu_torch import native as N
from jsplayer_tpu_torch.core.source import MemorySource
from jsplayer_tpu_torch.pipeline import ingest as P
from jsplayer_tpu_torch.pipeline import mesh as PM
from jsplayer_tpu_torch.utils.logging import LOG
from test_torch_ingest import ELIDED_BATCHES, assert_windows_equal, no_native

torch.set_num_threads(1)


class Log(list):
    """What happened, in order; `pin(on)` turns the planes' lock on."""


class FakeEvent:
    """upload_guard's event: logs its recording and every wait on it."""

    def __init__(self, log, device):
        self.log, self.device = log, device
        log.append(("record", self))

    def synchronize(self):
        self.log.append(("wait", self))


@pytest.fixture
def log(monkeypatch):
    """A pool and a pinned registry of the test's own; plain pipelines as
    they are, and after `log.pin(True)` pipelines that page-lock their
    planes (a stub lock) and record FakeEvents; the log of records, waits,
    fills, blocking uploads ("put") and pinned copies ("into")."""
    log = Log()
    monkeypatch.setattr(P, "_BUFFER_POOL", {})
    monkeypatch.setattr(D, "_PINNED", [])
    monkeypatch.setattr(D, "_register_host", lambda ptr, n: True)
    monkeypatch.setattr(D, "_unregister_host", lambda ptr: None)
    monkeypatch.setattr(P, "upload_guard",
                        lambda device: FakeEvent(log, device))

    def fills(name):
        raw = getattr(N.NativeScreenPressor, name)

        def fill(self, *a, **k):
            log.append(("fill", name))
            return raw(self, *a, **k)
        monkeypatch.setattr(N.NativeScreenPressor, name, fill)

    fills("decompress_kmv")
    fills("decompress_bc")
    raw_prep = P.sp_recon.prepare_bc

    def prep(*a, **k):  # the oracle's fill writes what this returns
        log.append(("fill", "prepare_bc"))
        return raw_prep(*a, **k)

    monkeypatch.setattr(P.sp_recon, "prepare_bc", prep)
    raw_put, raw_into = D.to_device, D.to_device_into

    def put(a, device):
        log.append(("put", None))
        return raw_put(a, device)

    def into(a, out):
        log.append(("into" if D.is_pinned(a) else "put", None))
        return raw_into(a, out)

    for mod in (P, PM):
        monkeypatch.setattr(mod, "to_device", put)
    monkeypatch.setattr(P, "to_device_into", into)
    log.pin = lambda on: monkeypatch.setattr(
        P.VideoIngestPipeline, "_pins_planes", on)
    return log


def run(sources, dp=None, **kw):
    mesh = None if dp is None else PM.make_mesh(
        dp, 1, devices=[torch.device("cpu")] * dp)
    pipe = P.VideoIngestPipeline([MemorySource(s) for s in sources],
                                 P.IngestConfig(device="cpu", mesh=mesh,
                                                **kw))
    return pipe, list(pipe)


def check_order(log):
    """Every fill after the wait on every event recorded before it; no
    blocking upload between a window's pinned copies and the next wait;
    every wait on a recorded event → (records, waits)."""
    pending, copying, records, waits = set(), False, 0, 0
    for kind, x in log:
        if kind == "record":
            pending.add(x)
            records += 1
        elif kind == "wait":
            assert x in pending, "a wait on an event never recorded"
            pending.discard(x)
            copying = False
            waits += 1
        elif kind == "fill":
            assert not pending, "the plane refilled while copies read it"
        elif kind == "into":
            copying = True
        elif kind == "put":
            assert not copying, "a blocking upload after the pinned copies"
    return records, waits


def plane_bufs(pinned=None):
    """The pool's plane buffers (those pinned or not, if asked)."""
    return {k: b for k, b in P._BUFFER_POOL.items() if "guard" in b
            and pinned in (None, k[1])}


@pytest.mark.parametrize("batch", sorted(ELIDED_BATCHES))
@pytest.mark.parametrize("transport,native", [
    ("kmv", True), ("bc", True), ("bc", False)])
def test_refill_waits_for_the_guard(log, monkeypatch, batch, transport,
                                    native):
    """Two pipelines in turn on one pooled plane, every window elided:
    each fill waits on the events of the copies before it, the first
    pipeline's last window's included (the buffer went back to the pool
    with them); the windows equal a pageable run's, and upload.pinned_bytes
    is the direct rows' planes."""
    if not native:
        no_native(monkeypatch)
    sources, window, stats = ELIDED_BATCHES[batch]()
    kw = dict(window=window, still_elision=True, sp_device_path=transport,
              model_downscale=2)
    plain_pipe, plain = run(sources, **kw)
    assert not D._PINNED and {k for k, _ in log} == {"fill", "put"}
    log.pin(True)
    before = LOG.counters.copy()
    pipe, first = run(sources, **kw)
    got = LOG.counters - before
    assert pipe.stats == plain_pipe.stats == stats
    (buf,) = plane_bufs(pinned=True).values()
    assert D.is_pinned(buf["plane"]) and buf["guard"]
    _, second = run(sources, **kw)
    assert_windows_equal(plain, first)
    assert_windows_equal(plain, second)
    records, waits = check_order(log)
    windows = sum(stats.values())
    assert records == 2 * windows and waits == 2 * windows - 1
    Y, X = buf["plane"].shape[2:]
    assert got["upload.pinned_bytes"] == got["elision.direct_rows"] * Y * X * 4


def test_pool_keys_keep_pinned_and_pageable_apart(log):
    sources, window, _ = ELIDED_BATCHES["mixed"]()
    kw = dict(window=window, still_elision=True)
    run(sources, **kw)
    (key_a, a), = plane_bufs().items()
    assert key_a[:2] == ("kmv", False)
    assert not D.is_pinned(a["plane"]) and not a["guard"]
    log.pin(True)
    run(sources, **kw)
    bufs = plane_bufs()
    assert len(bufs) == 2 and bufs[key_a] is a
    (key_b, b), = ((k, v) for k, v in bufs.items() if v is not a)
    assert D.is_pinned(b["plane"]) and not D.is_pinned(a["plane"])
    log.pin(False)
    pipe = P.VideoIngestPipeline([MemorySource(s) for s in sources],
                                 P.IngestConfig(device="cpu", **kw))
    for _ in pipe:
        assert next(v for v in pipe._bufs.values() if "guard" in v) is a
    log.pin(True)
    pipe = P.VideoIngestPipeline([MemorySource(s) for s in sources],
                                 P.IngestConfig(device="cpu", **kw))
    for _ in pipe:
        assert next(v for v in pipe._bufs.values() if "guard" in v) is b


@pytest.mark.parametrize("transport", ["kmv", "bc"])
def test_mesh_slots_guard_their_copies(log, transport):
    """A dp=2 mesh of CPU slots: each slot's copies from the pinned plane
    record an event on its device, the blocking uploads of every slot
    come before any slot's pinned copies, and the windows equal a
    pageable run's."""
    sources, window, _ = ELIDED_BATCHES["mixed"]()
    sources = list(sources) + [sources[0]]
    kw = dict(window=window, still_elision=True, sp_device_path=transport,
              model_downscale=2)
    _, plain = run(sources, dp=2, **kw)
    log.pin(True)
    pipe, pinned = run(sources, dp=2, **kw)
    assert_windows_equal(plain, pinned)
    records, waits = check_order(log)
    windows = pipe.stats["padded_windows"]
    assert windows and records == 2 * windows
    assert waits == records - 2


def test_pin_host_registers_own_bytes_once(monkeypatch):
    """pin_host locks an array's own bytes, not a view's; is_pinned holds
    for its contiguous slices; the lock goes when the array does."""
    gone = []
    monkeypatch.setattr(D, "_PINNED", [])
    monkeypatch.setattr(D, "_register_host", lambda ptr, n: n > 0)
    monkeypatch.setattr(D, "_unregister_host", gone.append)
    a = np.zeros((3, 4, 8), dtype=np.uint32)
    assert not D.pin_host(a[1:])
    assert D.pin_host(a)
    assert D._PINNED == [(a.ctypes.data, a.ctypes.data + a.nbytes)]
    assert D.is_pinned(a[1]) and D.is_pinned(a[1:3])
    assert not D.is_pinned(a[:, 1]) and not D.is_pinned(np.zeros_like(a))
    ptr = a.ctypes.data
    del a
    assert gone == [ptr] and D._PINNED == []
    assert not D.pin_host(np.zeros((0, 4), dtype=np.uint32))


def test_to_device_into_counts_pinned_bytes(monkeypatch):
    monkeypatch.setattr(D, "_PINNED", [])
    monkeypatch.setattr(D, "_register_host", lambda ptr, n: True)
    monkeypatch.setattr(D, "_unregister_host", lambda ptr: None)
    a = np.zeros((2, 3, 4), dtype=np.uint32)
    a[:] = np.arange(24).reshape(2, 3, 4)
    b = a + 1
    assert D.pin_host(a)
    out = torch.empty((2, 3, 4), dtype=torch.int32)
    before = LOG.counters.copy()
    D.to_device_into(a, out)
    D.to_device_into(b, out)
    got = LOG.counters - before
    assert got["upload.pinned_bytes"] == a.nbytes
    assert got["upload.bytes"] == 2 * a.nbytes and got["upload.calls"] == 2
    assert torch.equal(out, torch.from_numpy(b.view(np.int32)))

"""Structured host-side tracing/metrics.

Parity surface: the reference's Logging module (Logging.hx:8-62) — gated
trace (MLog :8-14), an in-memory timed event log capped at 4000 entries
(FastLog/TimedMsg :26-30, 42-62), and deferred rendering with deltas
(FlushLog :32-39) — plus the ELog stamp helper (DataLoader.hx:413-422).

TPU-era extensions: span() context manager for host-stage timing, counters
for pipeline observability (bytes fetched / frames demuxed / decoded /
output, buffer occupancy — SURVEY.md §5.5).  In place of the reference's
jax.profiler hook, TRACE (after LOG) is the ingest pipeline's tracer: its
``jsp.*`` spans open torch.profiler.record_function annotations while a
torch.profiler session records, and TRACE.summary() reads their self and
total times and the LOG counters the session added.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import Counter
from dataclasses import dataclass, field
from typing import Optional

MAX_EVENTS = 4000  # Logging.hx:27


@dataclass
class TimedMsg:
    """Logging.TimedMsg (Logging.hx:42-62)."""

    msg: str
    t0: Optional[float]
    t1: float

    def render(self, prev_t1: Optional[float]) -> str:
        parts = [f"t={self.t1:.6f}"]
        if self.t0 is not None:
            parts.append(f"dt={self.t1 - self.t0:.6f}")
        if prev_t1 is not None:
            parts.append(f"+{self.t1 - prev_t1:.6f}")
        return f"[{' '.join(parts)}] {self.msg}"


@dataclass
class Log:
    enabled: bool = False  # ≙ -Dlogging compile flag, now runtime
    extra: bool = False  # ≙ Logging.extra gate (DataLoader.hx:417)
    events: list[TimedMsg] = field(default_factory=list)
    counters: Counter = field(default_factory=Counter)
    _fast_on: bool = True

    def mlog(self, msg: str) -> None:
        # Logging.MLog (Logging.hx:8-14)
        if self.enabled:
            print(msg)

    def fast_log(self, msg: str, t0: Optional[float] = None,
                 t1: Optional[float] = None) -> None:
        # Logging.FastLog (Logging.hx:26-30): auto-disables after the cap
        if not self._fast_on:
            return
        self.events.append(TimedMsg(msg, t0, t1 if t1 is not None
                                    else time.monotonic()))
        if len(self.events) >= MAX_EVENTS:
            self._fast_on = False

    def elog(self, msg: str, t0: Optional[float] = None) -> float:
        # DataLoader.ELog (DataLoader.hx:413-422)
        t = time.monotonic()
        if self.enabled and self.extra:
            self.fast_log(msg, t0, t)
        return t

    def flush(self) -> list[str]:
        # Logging.FlushLog (Logging.hx:32-39)
        out = []
        prev = None
        for e in self.events:
            out.append(e.render(prev))
            prev = e.t1
        self.events.clear()
        self._fast_on = True
        return out

    @contextlib.contextmanager
    def span(self, name: str):
        """Host-stage timing span (TPU-era replacement for the hand-placed
        performance.now() pairs, Main.hx:1213-1226)."""
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.fast_log(name, t0, time.monotonic())

    def count(self, key: str, n: int = 1) -> None:
        self.counters[key] += n


LOG = Log()  # process-wide default instance


# -- the ingest pipeline's tracer --------------------------------------------
#
# On only while a torch.profiler session records: the pipeline polls
# torch.autograd._profiler_enabled() once per construction and once per
# window and keeps the answer in TRACE.active.  Off, a span site costs one
# attribute test and the shared no-op context manager.  On, each span opens
# torch.profiler.record_function(name), so the profiler's trace holds it on
# the device events' clock, and its duration, parent and window id are
# kept here.  A session is everything since the profiler was last seen
# turning on; its counters are the LOG counters it added.

MAX_RECORDS = 1 << 16  # raw span records kept a session


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("tracer", "name", "window", "parent", "child_ns", "t0",
                 "rf")

    def __init__(self, tracer, name, window):
        self.tracer, self.name, self.window = tracer, name, window

    def __enter__(self):
        import torch

        stack = self.tracer._stack()
        self.parent = stack[-1] if stack else None
        if self.window is None and self.parent is not None:
            self.window = self.parent.window
        self.child_ns = 0
        self.t0 = time.perf_counter_ns()
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        stack.append(self)
        return self

    def __exit__(self, *exc):
        self.tracer._stack().pop()
        self.rf.__exit__(None, None, None)
        self.tracer._close(self, time.perf_counter_ns())
        return False


class Tracer:
    """Spans a window (name, window id, parent, perf_counter_ns t0/t1) on
    a per-thread stack; per name the calls, the total and the self time
    (duration less the child spans'), and the raw records, capped."""

    def __init__(self, log: Log):
        self.log = log
        self.active = False
        self._local = threading.local()
        self._begin()

    def _begin(self) -> None:
        self.stats: dict = {}  # name -> [calls, total_ns, self_ns]
        self.records: list = []  # (name, window, parent name, t0, t1)
        self._counters0 = Counter(self.log.counters)

    def poll(self) -> bool:
        """Ask the profiler whether it records; a session starts when it is
        first seen on."""
        import torch

        on = torch.autograd._profiler_enabled()
        if on and not self.active:
            self._begin()
        self.active = on
        return on

    def span(self, name: str, window=None):
        """A context manager: a span of `name` in `window` (the parent
        span's when None) while active, else the shared no-op."""
        if not self.active:
            return _NO_SPAN
        return _Span(self, name, window)

    def window(self):
        """The window id of the innermost span open on this thread."""
        stack = self._stack()
        return stack[-1].window if stack else None

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _close(self, sp: _Span, t1: int) -> None:
        d = t1 - sp.t0
        if sp.parent is not None:
            sp.parent.child_ns += d
        st = self.stats.get(sp.name)
        if st is None:
            st = self.stats[sp.name] = [0, 0, 0]
        st[0] += 1
        st[1] += d
        st[2] += d - sp.child_ns
        if len(self.records) < MAX_RECORDS:
            parent = sp.parent.name if sp.parent is not None else None
            self.records.append((sp.name, sp.window, parent, sp.t0, t1))

    def summary(self) -> dict:
        """The session: {"self_s", "total_s", "calls"} by span name and
        "counters", what it added to each LOG counter."""
        c0 = self._counters0
        return {
            "self_s": {k: v[2] / 1e9 for k, v in self.stats.items()},
            "total_s": {k: v[1] / 1e9 for k, v in self.stats.items()},
            "calls": {k: v[0] for k, v in self.stats.items()},
            "counters": {k: n - c0.get(k, 0)
                         for k, n in self.log.counters.items()
                         if n != c0.get(k, 0)}}


TRACE = Tracer(LOG)  # the ingest pipeline's tracer

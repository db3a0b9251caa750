"""Structured host-side tracing/metrics.

Parity surface: the reference's Logging module (Logging.hx:8-62) — gated
trace (MLog :8-14), an in-memory timed event log capped at 4000 entries
(FastLog/TimedMsg :26-30, 42-62), and deferred rendering with deltas
(FlushLog :32-39) — plus the ELog stamp helper (DataLoader.hx:413-422).

TPU-era extensions: span() context manager for host-stage timing, counters
for pipeline observability (bytes fetched / frames demuxed / decoded /
output, buffer occupancy — SURVEY.md §5.5).
"""

from __future__ import annotations

import contextlib
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

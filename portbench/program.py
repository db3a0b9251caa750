"""What the port's own tracer saw in a traced run.

``jsplayer_tpu_torch.utils.logging.TRACE`` opens the pipeline's ``jsp.*``
spans while a torch.profiler session records, as the traced window does,
and its ``summary()`` gives, for that session, each span's self and total
seconds and calls and what the session added to each of the port's LOG
counters.  The metrics that read it (metrics/*.py) share these helpers.
A port without the tracer gives None, and those metrics nothing.
"""

from __future__ import annotations


def summary():
    """TRACE.summary() of the port, or None where it has no tracer."""
    try:
        from jsplayer_tpu_torch.utils.logging import TRACE
    except ImportError:
        return None
    return TRACE.summary()


def self_ms_per_frame(ctx, span: str):
    """Host ms a delivered frame of `span`'s self time (its duration less
    its child spans'), or None when it never ran."""
    s = summary()
    v = None if s is None else s["self_s"].get(span)
    return None if v is None or not ctx.frames else 1e3 * v / ctx.frames


def counter(name: str):
    """What the session added to the port's counter `name`, or None."""
    s = summary()
    return None if s is None else s["counters"].get(name)

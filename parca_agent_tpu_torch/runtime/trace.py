"""The window trace's call-site surface, without a recorder.

parca_agent_tpu's flight recorder (runtime/trace.py there) records one
trace per window, with spans from the profiler loop, the encode
pipeline's worker and the encoder. This port carries only what those
call sites need, so they read as they do there: NULL_TRACE, the trace
that records nowhere (its spans still measure), and observe(), the
deep-component hook, which does nothing: no recorder exists here yet.
"""

from __future__ import annotations

import time


class _SpanCtx:
    """Context manager for one timed span. Always measures (callers read
    .duration_s as a gauge); recording is the trace's problem. User
    exceptions are recorded and re-raised."""

    __slots__ = ("_trace", "_stage", "_t0", "duration_s")

    def __init__(self, trace, stage: str):
        self._trace = trace
        self._stage = stage
        self.duration_s = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, et, ev, tb):
        self.duration_s = time.perf_counter() - self._t0
        self._trace.add_span(
            self._stage, self.duration_s,
            error=(repr(ev)[:200] if ev is not None else None))
        return False


class _NullTrace:
    """The do-nothing trace: call sites never branch on whether tracing
    is enabled. Spans still measure (see _SpanCtx) but record nowhere."""

    seq = 0
    completed = True
    detached = False

    def span(self, stage: str) -> _SpanCtx:
        return _SpanCtx(self, stage)

    def add_span(self, stage, duration_s, error=None,
                 histogram=True) -> None:
        pass

    def annotate(self, **kv) -> None:
        pass

    def detach(self) -> None:
        pass

    def complete(self, error: str | None = None) -> None:
        pass


NULL_TRACE = _NullTrace()


def observe(stage: str, duration_s: float) -> None:
    """The deep-component hook (the encoder's statics builds). It feeds
    the installed recorder's stage histograms; the port has no recorder
    yet, so it does nothing."""

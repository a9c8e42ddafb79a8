"""Structured tracer: nested spans, ring buffer, Chrome trace export (port
of ``repro.obs.trace``, copied as it is).

Spans are recorded with the same clock the engine stamps ``Request``
timestamps with (``time.perf_counter``), so per-request events line up
with tick-phase spans on one timeline.  The API is a context manager:

    with tracer.span("tick", tick=7):
        with tracer.span("dispatch"):
            ...

Recording is a ring buffer (``collections.deque(maxlen=capacity)``):
old spans fall off, memory stays bounded, and the hot path is an
append + two clock reads.  A disabled tracer (the default, and the
shared ``NULL_TRACER``) short-circuits to a reusable no-op context
manager, so instrumented code pays one attribute check when tracing is
off — that is the overhead contract of the engine's tick loop.

Export is Chrome/Perfetto ``trace_event`` JSON: complete events
(``ph="X"`` with ``ts``/``dur`` in microseconds) for spans, instant
events (``ph="i"``) for point occurrences like ft events.  Load the
file in ``chrome://tracing`` or https://ui.perfetto.dev.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any

__all__ = ["Span", "Tracer", "NULL_TRACER"]


def _now_us() -> float:
    return time.perf_counter() * 1e6


@dataclass
class Span:
    """One completed span (or instant, when ``dur_us`` is None)."""

    name: str
    ts_us: float                    # start, perf_counter microseconds
    dur_us: float | None = None     # None => instant event
    depth: int = 0                  # nesting depth at record time
    args: dict = field(default_factory=dict)

    def to_event(self, pid: int, tid: int) -> dict:
        ev: dict[str, Any] = {
            "name": self.name,
            "ph": "X" if self.dur_us is not None else "i",
            "ts": self.ts_us,
            "pid": pid,
            "tid": tid,
        }
        if self.dur_us is not None:
            ev["dur"] = self.dur_us
        else:
            ev["s"] = "t"  # instant scope: thread
        if self.args:
            ev["args"] = self.args
        return ev


class _NullSpanCtx:
    """Reusable no-op context manager — the disabled-tracer fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args) -> None:
        pass


_NULL_SPAN_CTX = _NullSpanCtx()


class _SpanCtx:
    """Live span: records on ``__exit__`` so nesting depth is exact."""

    __slots__ = ("tracer", "name", "args", "ts_us", "depth")

    def __init__(self, tracer: "Tracer", name: str, args: dict):
        self.tracer = tracer
        self.name = name
        self.args = args

    def __enter__(self):
        self.depth = len(self.tracer._stack)
        self.tracer._stack.append(self.name)
        self.ts_us = _now_us()
        return self

    def __exit__(self, exc_type, exc, tb):
        end = _now_us()
        stack = self.tracer._stack
        if stack and stack[-1] == self.name:
            stack.pop()
        if exc_type is not None:
            self.args = dict(self.args, error=exc_type.__name__)
        self.tracer._record(Span(self.name, self.ts_us, end - self.ts_us,
                                 self.depth, self.args))
        return False

    def set(self, **args) -> None:
        """Attach extra args after entry (e.g. counts known at exit)."""
        self.args = dict(self.args, **args)


class Tracer:
    """Ring-buffered span recorder; disabled (no-op) by default."""

    def __init__(self, capacity: int = 8192, enabled: bool = False):
        self.capacity = capacity
        self.enabled = enabled
        self.events: deque[Span] = deque(maxlen=capacity)
        self.dropped = 0
        self._stack: list[str] = []
        self._lock = threading.Lock()

    # -- control -----------------------------------------------------------
    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        self.events.clear()
        self.dropped = 0
        self._stack.clear()

    # -- recording ---------------------------------------------------------
    def span(self, name: str, **args):
        if not self.enabled:
            return _NULL_SPAN_CTX
        return _SpanCtx(self, name, args)

    def instant(self, name: str, **args) -> None:
        if not self.enabled:
            return
        self._record(Span(name, _now_us(), None, len(self._stack), args))

    def _record(self, span: Span) -> None:
        if len(self.events) == self.events.maxlen:
            self.dropped += 1
        self.events.append(span)

    # -- export ------------------------------------------------------------
    def chrome_trace(self, pid: int | None = None) -> dict:
        """``trace_event`` JSON object (the `{"traceEvents": [...]}` form)."""
        pid = os.getpid() if pid is None else pid
        tid = threading.get_ident() % 100000
        return {
            "traceEvents": [s.to_event(pid, tid) for s in self.events],
            "displayTimeUnit": "ms",
            "otherData": {"dropped_spans": self.dropped},
        }

    def export_chrome(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path

    def spans(self, name: str | None = None) -> list[Span]:
        if name is None:
            return list(self.events)
        return [s for s in self.events if s.name == name]


NULL_TRACER = Tracer(capacity=1, enabled=False)

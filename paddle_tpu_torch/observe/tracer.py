"""Structured span tracer: a bounded ring buffer of timed events.

The part of ``paddle_tpu/observe/tracer.py`` the serving path records
into: the request, batch and generation spans of ``serve/`` arrive as
raw tuples under their trace contexts (``observe/xray.py``) and are
materialized into `Span` objects when read. Host only. The reference's
nested host spans, aggregation, chrome://tracing export and
multi-process merge are not ported.

The ring is bounded (default 16384 events): a long-running server cannot
grow host memory through telemetry — old events fall off the back,
aggregate counts live in observe.metrics instead.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import List, Optional

DEFAULT_CAPACITY = 16384


class Span:
    """One completed timed event (chrome "X" phase)."""

    __slots__ = ("name", "cat", "ts", "dur", "tid", "depth", "args")

    def __init__(self, name: str, cat: str, ts: float, dur: float,
                 tid: int, depth: int = 0, args: Optional[dict] = None):
        self.name = name
        self.cat = cat
        self.ts = ts          # wall-clock seconds (time.time epoch)
        self.dur = dur        # seconds (perf_counter delta)
        self.tid = tid
        self.depth = depth
        self.args = args or {}

    def __repr__(self):
        return (f"Span({self.name!r}, cat={self.cat!r}, "
                f"dur={self.dur * 1e3:.3f}ms, depth={self.depth})")


class Tracer:
    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self._events: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()

    @property
    def capacity(self) -> int:
        return self._events.maxlen

    def record_ctx(self, name: str, ts: float, dur: float, cat: str,
                   ctx, extra: dict):
        """Hot-path append for xray spans: the ring stores a raw tuple
        (no Span object, no trace-id formatting, no args-dict merge) and
        `events()` materializes it into a Span on read. The serve path
        records 2+ spans per request and reads them rarely, so the
        formatting is deferred to the read. `ctx` is an immutable
        SpanContext and `extra` is relinquished by the caller (stored,
        not copied)."""
        tid = threading.get_ident()
        with self._lock:
            self._events.append((name, cat, ts, dur, tid, ctx, extra))

    @staticmethod
    def _materialize(ev) -> Span:
        name, cat, ts, dur, tid, ctx, extra = ev
        args = ctx.trace_args()
        if extra:
            args.update(extra)
        return Span(name, cat, ts, dur, tid, 0, args)

    def events(self, cat: Optional[str] = None) -> List[Span]:
        with self._lock:
            evs = list(self._events)
        spans = [self._materialize(e) for e in evs]
        return spans if cat is None else [e for e in spans if e.cat == cat]

    def clear(self):
        with self._lock:
            self._events.clear()

    def __len__(self):
        with self._lock:
            return len(self._events)


_tracer = Tracer()


def get_tracer() -> Tracer:
    return _tracer

"""Structured span tracer: a bounded ring buffer of timed events.

The part of ``paddle_tpu/observe/tracer.py`` the port records into:
the request, batch and generation spans of ``serve/`` arrive as raw
tuples under their trace contexts (``observe/xray.py``) and are
materialized into `Span` objects when read; nested host spans
(`span`, `record`: ``profiler.record_event``, the Trainer's epoch marks)
are stored as `Span`s. `aggregate` and `export_chrome` serve
``profiler.print_host_events`` and ``profiler.export_chrome_tracing``.
Host only. The JAX package's multi-process trace merge is not ported.

The ring is bounded (default 16384 events): a long-running server cannot
grow host memory through telemetry — old events fall off the back,
aggregate counts live in observe.metrics instead.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

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
        self._local = threading.local()

    @property
    def capacity(self) -> int:
        return self._events.maxlen

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "host", **args):
        """Timed nested region, recorded even when the body raises;
        nesting depth is tracked per thread and stored on the event."""
        stack = self._stack()
        depth = len(stack)
        stack.append(name)
        ts = time.time()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dur = time.perf_counter() - t0
            stack.pop()
            self.record(name, ts, dur, cat=cat, depth=depth,
                        parent=stack[-1] if stack else None, **args)

    def record(self, name: str, ts: float, dur: float, cat: str = "host",
               depth: int = 0, parent=None, **args) -> Span:
        """Append a completed span (for callers that timed the region
        themselves)."""
        if parent is not None:
            args = dict(args, parent=parent)
        ev = Span(name, cat, ts, dur, threading.get_ident(), depth, args)
        with self._lock:
            self._events.append(ev)
        return ev

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
        if ev.__class__ is Span:
            return ev
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

    def aggregate(self, cat: Optional[str] = None) -> Dict[str, list]:
        """name -> [calls, total_s, max_s, min_s] over recorded events."""
        agg: Dict[str, list] = {}
        for e in self.events(cat=cat):
            a = agg.setdefault(e.name, [0, 0.0, 0.0, float("inf")])
            a[0] += 1
            a[1] += e.dur
            a[2] = max(a[2], e.dur)
            a[3] = min(a[3], e.dur)
        return agg

    def chrome_events(self, cat: Optional[str] = None) -> List[dict]:
        """The spans as chrome://tracing "X" events under this process's
        pid, after "M" events naming the process and its live threads."""
        pid = os.getpid()
        spans, tids = [], set()
        for e in self.events(cat=cat):
            ev = {"name": e.name, "ph": "X", "pid": pid, "tid": e.tid,
                  "ts": int(e.ts * 1e6), "dur": int(e.dur * 1e6),
                  "cat": e.cat}
            if e.args or e.depth:
                ev["args"] = dict(e.args, depth=e.depth)
            spans.append(ev)
            tids.add(e.tid)
        meta = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                 "args": {"name": f"pid{pid}"}}]
        names = {t.ident: t.name for t in threading.enumerate()}
        meta += [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                  "args": {"name": names[tid]}}
                 for tid in sorted(tids) if tid in names]
        return meta + spans

    def export_chrome(self, path: str, cat: Optional[str] = None) -> str:
        """Write the ring as chrome://tracing JSON."""
        with open(path, "w") as f:
            json.dump({"traceEvents": self.chrome_events(cat=cat),
                       "displayTimeUnit": "ms"}, f)
        return path


_tracer = Tracer()


def get_tracer() -> Tracer:
    return _tracer

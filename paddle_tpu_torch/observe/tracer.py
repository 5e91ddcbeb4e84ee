"""Structured span tracer: a bounded ring buffer of timed events with
parent/child nesting and chrome://tracing JSON export.

Reference analog: platform/profiler.cc's RecordEvent host-event table +
tools/timeline.py's chrome-trace conversion, unified into one store. The
`profiler` module's `record_event` / `print_host_events` /
`export_chrome_tracing` API is now a thin veneer over this tracer, so
host annotations, executor step phases, trainer epoch marks and RPC spans
all land in ONE timeline.

The ring is bounded (default 16384 events): a week-long training run
cannot grow host memory through telemetry — old events fall off the back,
aggregate counts live in observe.metrics instead.

Copy of ``paddle_tpu/observe/tracer.py``, its imports rewired to this
package.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

DEFAULT_CAPACITY = 16384

# chrome-trace process identity (fluid-xray): exports carry the REAL pid
# plus a human process name as "M"-phase metadata, so per-process trace
# files from a distributed run merge into one timeline with each process
# on its own named track (tools/telemetry_dump.py --merge).
_process_name: Optional[str] = None


def set_process_name(name: str):
    global _process_name
    _process_name = str(name)


def get_process_name() -> str:
    if _process_name is not None:
        return _process_name
    return os.environ.get("PADDLE_TPU_PROC_NAME", f"pid{os.getpid()}")


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
        # tid -> thread name, captured at RECORD time: a batcher/conn
        # thread may be long gone by export time, and an unnamed track
        # defeats the merged timeline's readability
        self._tid_names: Dict[int, str] = {}

    @property
    def capacity(self) -> int:
        return self._events.maxlen

    def set_capacity(self, capacity: int):
        """Re-bound the ring, keeping the most recent events that fit."""
        with self._lock:
            self._events = deque(self._events, maxlen=capacity)

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "host", **args):
        """Timed nested region. The event is recorded even when the body
        raises (the failing iteration is usually the one being profiled);
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
               tid: Optional[int] = None, depth: int = 0, parent=None,
               **args):
        """Append a completed span directly (for callers that timed the
        region themselves, e.g. the executor's phase timers)."""
        if parent is not None:
            args = dict(args, parent=parent)
        name_update = None
        if tid is None:
            tid = threading.get_ident()
            # unconditional refresh: idents recycle after a thread exits,
            # and a stale name on a recycled tid would mislabel the track
            name_update = threading.current_thread().name
        ev = Span(name, cat, ts, dur, tid, depth, args)
        with self._lock:
            if name_update is not None:
                self._tid_names[tid] = name_update
            self._events.append(ev)
        return ev

    def record_ctx(self, name: str, ts: float, dur: float, cat: str,
                   ctx, extra: dict):
        """Hot-path append for xray spans: the ring stores a raw tuple
        (no Span object, no trace-id formatting, no args-dict merge) and
        `events()` materializes it into a Span on read. The serve path
        records 2+ spans per request and exports ~never, so the horizon
        A/B prices exactly this deferral. `ctx` is an immutable
        SpanContext and `extra` is relinquished by the caller (stored,
        not copied)."""
        tid = threading.get_ident()
        with self._lock:
            if tid not in self._tid_names:
                # conditional (unlike `record`'s refresh): serve/RPC hot
                # threads are long-lived, and a recycled ident keeping a
                # dead thread's track name is cosmetic — not worth a
                # current_thread() lookup per request
                self._tid_names[tid] = threading.current_thread().name
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
        if cat is not None:
            return [e for e in map(self._materialize, evs) if e.cat == cat]
        return [self._materialize(e) for e in evs]

    def clear(self):
        with self._lock:
            self._events.clear()
            # thread names must reset with the events: a recycled thread
            # ident would otherwise label a later span's track with a
            # dead thread's name in the chrome export
            self._tid_names.clear()

    def __len__(self):
        with self._lock:
            return len(self._events)

    # -- aggregation (the reference DisableProfiler printed table) ---------
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

    # -- chrome://tracing export -------------------------------------------
    def chrome_events(self, cat: Optional[str] = None) -> List[dict]:
        """Span ("X") events under this process's REAL pid, prefixed with
        "M" metadata naming the process and its threads — required for a
        multi-process merge to render as distinct named tracks."""
        pid = os.getpid()
        spans = []
        tids = set()
        for e in self.events(cat=cat):
            ev = {"name": e.name, "ph": "X", "pid": pid, "tid": e.tid,
                  "ts": int(e.ts * 1e6), "dur": int(e.dur * 1e6),
                  "cat": e.cat}
            if e.args or e.depth:
                ev["args"] = dict(e.args, depth=e.depth)
            spans.append(ev)
            tids.add(e.tid)
        meta = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                 "args": {"name": get_process_name()}}]
        # record-time names first (threads may have exited since), live
        # threads as a fallback for spans recorded with an explicit tid
        thread_names = {t.ident: t.name for t in threading.enumerate()
                        if t.ident is not None}
        with self._lock:   # a recording thread may be inserting a new tid
            thread_names.update(self._tid_names)
        for tid in sorted(tids):
            name = thread_names.get(tid)
            if name:
                meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                             "tid": tid, "args": {"name": name}})
        return meta + spans

    def export_chrome(self, path: str, cat: Optional[str] = None) -> str:
        """Write the ring as chrome://tracing JSON (reference
        tools/timeline.py emits the same schema from the profiler proto)."""
        with open(path, "w") as f:
            json.dump({"traceEvents": self.chrome_events(cat=cat),
                       "displayTimeUnit": "ms"}, f)
        return path


_tracer = Tracer()


def get_tracer() -> Tracer:
    return _tracer


# -- multi-process merge (fluid-xray) ---------------------------------------

def load_chrome_trace(path: str) -> dict:
    """Load one chrome-trace JSON file with a diagnosable failure mode:
    an empty or non-JSON file raises ValueError NAMING the file (a
    distributed drill merging N per-process dumps must say which worker
    produced the bad one, not surface a bare JSONDecodeError), as does a
    document without a `traceEvents` list."""
    try:
        with open(path) as f:
            text = f.read()
    except OSError as e:
        raise ValueError(f"unreadable trace file {path!r}: {e}") from e
    if not text.strip():
        raise ValueError(f"empty trace file {path!r} (the producing "
                         "process likely died before export)")
    try:
        doc = json.loads(text)
    except json.JSONDecodeError as e:
        raise ValueError(f"malformed trace file {path!r}: {e}") from e
    if not isinstance(doc, dict) or not isinstance(
            doc.get("traceEvents"), list):
        raise ValueError(f"trace file {path!r} has no traceEvents list")
    return doc


def merge_chrome_traces(paths: Sequence[str],
                        out_path: Optional[str] = None,
                        strict: bool = False
                        ) -> Tuple[dict, dict]:
    """Stitch per-process chrome-trace files into ONE timeline.

    Every "X" span of every input survives verbatim (the caller can —
    and chaos drills do — fail hard when `spans_out != spans_in`;
    `strict=True` makes the merge itself raise RuntimeError on that
    mismatch). Process identity is kept distinct: if two files claim
    the same pid but different process names (a restarted worker
    recycling a pid, or two single-process drills merged after the
    fact), the later file's events are remapped onto a fresh synthetic
    pid. Metadata ("M") events are deduplicated per (pid, name, tid).
    Empty or malformed input files raise ValueError naming the file
    (`load_chrome_trace`).

    Returns (merged_doc, stats) where stats carries per-file and total
    span counts; `out_path` additionally writes the merged JSON."""
    merged_meta: List[dict] = []
    merged_spans: List[dict] = []
    seen_meta = set()
    pid_owner: Dict[int, str] = {}      # pid -> process name that owns it
    used_pids = set()
    stats = {"files": {}, "spans_in": 0, "spans_out": 0, "processes": []}
    for path in paths:
        doc = load_chrome_trace(path)
        events = doc.get("traceEvents", [])
        # span budget counted straight off the LOADED file, independent
        # of the transform loop below — so the spans_out gate actually
        # catches a future merge change that filters events
        n_spans = sum(1 for ev in events if ev.get("ph") != "M")
        pname = None
        for ev in events:
            if ev.get("ph") == "M" and ev.get("name") == "process_name":
                pname = ev.get("args", {}).get("name")
                break
        pname = pname or os.path.basename(path)
        # pid remap when a pid is already owned by a DIFFERENT process
        remap: Dict[int, int] = {}

        def _pid_of(ev):
            pid = ev.get("pid", 0)
            if pid in remap:
                return remap[pid]
            owner = pid_owner.get(pid)
            if owner is not None and owner != pname:
                new = pid
                while new in used_pids:
                    new += 1 << 20
                remap[pid] = new
                used_pids.add(new)
                pid_owner[new] = pname
                return new
            pid_owner[pid] = pname
            used_pids.add(pid)
            return pid

        for ev in events:
            ev = dict(ev, pid=_pid_of(ev))
            if ev.get("ph") == "M":
                key = (ev["pid"], ev.get("name"), ev.get("tid"),
                       json.dumps(ev.get("args", {}), sort_keys=True))
                if key in seen_meta:
                    continue
                seen_meta.add(key)
                merged_meta.append(ev)
            else:
                merged_spans.append(ev)
        stats["files"][path] = {"process": pname, "spans": n_spans}
        stats["spans_in"] += n_spans
        if pname not in stats["processes"]:
            stats["processes"].append(pname)
    merged_spans.sort(key=lambda e: e.get("ts", 0))
    doc = {"traceEvents": merged_meta + merged_spans,
           "displayTimeUnit": "ms"}
    stats["spans_out"] = len(merged_spans)
    if strict and stats["spans_out"] != stats["spans_in"]:
        raise RuntimeError(
            f"merge dropped spans: {stats['spans_in']} in, "
            f"{stats['spans_out']} out across {len(list(paths))} files")
    if out_path is not None:
        with open(out_path, "w") as f:
            json.dump(doc, f)
    return doc, stats

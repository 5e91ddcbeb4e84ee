"""W3C trace contexts for the serving path.

The part of ``paddle_tpu/observe/xray.py`` the serving path uses: the
W3C Trace Context trio — a 128-bit ``trace_id`` shared by every span of
one logical operation, a 64-bit ``span_id`` per span, and the parent's
span id — so a request's lifecycle span, the batch span that served it
and the caller's own spans form one trace.

Context flows through a `contextvars.ContextVar`. The MicroBatcher and
the decode engine finish requests on their own threads, so the
submitting thread captures `child_of()` and the executor thread records
under it. Emission is the caller's business to gate on the `observe`
flag — this module only allocates ids and appends to the (bounded)
tracer ring. The reference's wire format (``traceparent`` frames and
baggage, for its RPC planes) is not ported.
"""

from __future__ import annotations

import os
import random
import threading
from contextvars import ContextVar
from typing import Optional

from .. import flags as _flags
from . import tracer as _tracer

_cv: ContextVar[Optional["SpanContext"]] = ContextVar("xray_ctx",
                                                      default=None)
# guarded_by: _id_lock — lazy id resolution in SpanContext properties.
# One process-wide lock (not per-context) keeps the context itself a
# bare 4-slot object; resolution happens once per id, off the hot path.
_id_lock = threading.Lock()


class SpanContext:
    """Identity of one span: (trace_id, span_id, parent_span_id).

    Ids are LAZY: allocating a context on the serve hot path stores no
    ids at all (a child stores only a reference to its parent), and the
    hex id strings materialize on first property read, off the request's
    critical path. Resolution runs under a module lock so two readers
    racing on an unresolved id agree on ONE value (an id minted twice
    would orphan every child under the losing copy); resolved ids
    overwrite the slot, so the lock and the format cost are paid at most
    once per id."""

    __slots__ = ("_tid", "_sid", "_pid", "_parent")

    def __init__(self, trace_id=None, span_id=None, parent_id=None,
                 parent: Optional["SpanContext"] = None):
        self._tid = trace_id
        self._sid = span_id
        self._pid = parent_id
        self._parent = parent

    @property
    def trace_id(self) -> str:
        v = self._tid
        if v.__class__ is str:
            return v
        if v is None and self._parent is not None:
            # Inherit OUTSIDE the lock — the parent's own resolution is
            # locked and idempotent, so racing copiers all read the same
            # string, and _id_lock is not reentrant (taking it here
            # would deadlock the chain walk).
            v = self._tid = self._parent.trace_id
            return v
        with _id_lock:
            v = self._tid
            if v.__class__ is str:
                return v
            v = (format(_get_rng().getrandbits(128), "032x")
                 if v is None else format(v, "032x"))
            self._tid = v
        return v

    @property
    def span_id(self) -> str:
        v = self._sid
        if v.__class__ is str:
            return v
        with _id_lock:
            v = self._sid
            if v.__class__ is str:
                return v
            v = (format(_get_rng().getrandbits(64), "016x")
                 if v is None else format(v, "016x"))
            self._sid = v
        return v

    @property
    def parent_id(self) -> Optional[str]:
        v = self._pid
        if v is None:
            p = self._parent
            if p is None:
                return None
            v = self._pid = p.span_id
            return v
        if v.__class__ is not str:
            v = self._pid = format(v, "016x")
        return v

    def child(self) -> "SpanContext":
        """New span in the SAME trace, parented here."""
        return SpanContext(parent=self)

    def trace_args(self) -> dict:
        """The span-identity fields every xray tracer event carries."""
        args = {"trace_id": self.trace_id, "span_id": self.span_id}
        if self.parent_id:
            args["parent_span_id"] = self.parent_id
        return args

    def __repr__(self):
        return (f"SpanContext(trace={self.trace_id}, span={self.span_id}, "
                f"parent={self.parent_id})")


# ids need uniqueness, not unpredictability: a PRNG seeded once from the
# OS beats an os.urandom syscall per id on the serve hot path (every
# request allocates 2+ span ids). Seeded lazily PER PROCESS KEYED ON PID
# so a fork between imports can't make two processes' id streams collide.
_rng_pid: Optional[int] = None
_rng: Optional[random.Random] = None


def _get_rng() -> random.Random:
    global _rng, _rng_pid
    if _rng is None or _rng_pid != os.getpid():
        _rng = random.Random(int.from_bytes(os.urandom(16), "big"))
        _rng_pid = os.getpid()
    return _rng


# the trace-flag read sits on the per-request serve hot path (2+
# child_of calls per request), so it is memoized on the flag registry's
# version: one int compare per call instead of registry dict lookups,
# and a set_flag("trace", ...) flip still takes effect immediately
# (every set_flag bumps the version)
_trace_cache = (-1, True)


def _trace_on() -> bool:
    global _trace_cache
    ver = _flags.version()
    cached = _trace_cache
    if cached[0] != ver:
        cached = _trace_cache = (ver, bool(_flags.get_flag("trace")))
    return cached[1]


def current() -> Optional[SpanContext]:
    """The active span context of this thread/task, or None."""
    return _cv.get()


def child_of(parent: Optional[SpanContext] = None,
             inherit: bool = True) -> Optional[SpanContext]:
    """A fresh span context: child of `parent` (or of the ambient context
    when `inherit`), else the root of a brand-new trace. Returns None
    while the `trace` flag is off — every call site null-guards, so the
    kill switch degrades the whole plane to no spans."""
    if not _trace_on():
        return None
    if parent is None and inherit:
        parent = current()
    if parent is not None:
        return parent.child()
    return SpanContext()


def set_current(ctx: Optional[SpanContext]):
    """Make `ctx` the ambient context of this thread (a request's spans
    then parent under it); returns a token for `unset_current`."""
    return _cv.set(ctx)


def unset_current(token):
    _cv.reset(token)


def record_span(name: str, ctx: Optional[SpanContext], ts: float,
                dur: float, cat: str = "xray", **args):
    """Append an already-timed span under an explicit context. A None ctx
    (trace flag off) is a no-op."""
    if ctx is None:
        return
    return _tracer.get_tracer().record_ctx(name, ts, dur, cat, ctx, args)


def tracer():
    """The process tracer (hot-path callers that record straight via
    `Tracer.record_ctx` without the record_span null-check hop)."""
    return _tracer.get_tracer()


def reset():
    """Drop the ambient context of THIS thread (tests)."""
    _cv.set(None)

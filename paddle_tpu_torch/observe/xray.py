"""fluid-xray: cross-process distributed trace context.

The round-8 tracer records spans, but every span lives in ONE process's
ring: a pserver RPC shows up as a client-side wait in the trainer and an
unrelated handler blip on the server, with nothing tying them together.
This module adds the W3C Trace Context trio — a 128-bit ``trace_id``
shared by every span of one logical operation, a 64-bit ``span_id`` per
span, and the parent's span id — carried across the pserver RPC frame
and the serving request path, so a trainer+pserver chaos drill renders
as one timeline instead of N disconnected ones.

Wire format follows the W3C ``traceparent`` header
(``00-<trace_id:32hex>-<span_id:16hex>-01``); `to_wire`/`from_wire`
wrap it in a plain dict so the pickle-framed pserver RPC and any future
HTTP front-end serialize it the same way. A malformed or missing header
degrades to "no remote parent" — never an error (legacy peers without
the field keep interoperating).

Context flows through a `contextvars.ContextVar`: `span()` nests
naturally within a thread, and thread-crossing layers (MicroBatcher
futures, RPC handler threads) propagate explicitly via
`current()`/`activate()`. Emission is the caller's business to gate on
the `observe` flag — this module only allocates ids and appends to the
(bounded) tracer ring.

Copy of ``paddle_tpu/observe/xray.py``, its imports rewired to this
package.
"""

from __future__ import annotations

import contextlib
import os
import random
import threading
import time
from contextvars import ContextVar
from typing import Optional

from .. import flags as _flags
from . import tracer as _tracer

_WIRE_KEY = "traceparent"
_BAGGAGE_KEY = "baggage"
_BAGGAGE_MAX = 16
_cv: ContextVar[Optional["SpanContext"]] = ContextVar("xray_ctx",
                                                      default=None)
# guarded_by: _id_lock — lazy id resolution in SpanContext properties.
# One process-wide lock (not per-context) keeps the context itself a
# bare 5-slot object; resolution happens once per id, off the hot path.
_id_lock = threading.Lock()


class SpanContext:
    """Identity of one span: (trace_id, span_id, parent_span_id), plus
    optional `baggage` — small string key/values that ride the WHOLE
    trace (every child inherits them, `to_wire` carries them across
    processes), e.g. ``request_kind=infer`` or a drill scenario name.

    Ids are LAZY: allocating a context on the serve hot path stores no
    ids at all (a child stores only a reference to its parent), and the
    hex id strings materialize on first property read — at trace export
    or wire encode, off the request's critical path. Resolution runs
    under a module lock so two readers racing on an unresolved id agree
    on ONE value (an id minted twice would orphan every child under the
    losing copy); resolved ids overwrite the slot, so the lock and the
    format cost are paid at most once per id. Contexts parsed off the
    wire carry their hex strings from birth and never touch the lock."""

    __slots__ = ("_tid", "_sid", "_pid", "_parent", "baggage")

    def __init__(self, trace_id=None, span_id=None, parent_id=None,
                 baggage: Optional[dict] = None,
                 parent: Optional["SpanContext"] = None):
        self._tid = trace_id
        self._sid = span_id
        self._pid = parent_id
        self._parent = parent
        self.baggage = baggage or None

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
        """New span in the SAME trace, parented here (baggage rides)."""
        return SpanContext(baggage=self.baggage, parent=self)

    def with_baggage(self, **kv) -> "SpanContext":
        """Same span identity, baggage extended with `kv` (values are
        stringified — baggage is a wire-portable str->str map). Resolves
        lazy ids first: the copy must share the ORIGINAL's identity, not
        mint its own on a later read."""
        bag = dict(self.baggage or {})
        bag.update({str(k): str(v) for k, v in kv.items()})
        return SpanContext(self.trace_id, self.span_id, self.parent_id,
                           baggage=bag)

    def trace_args(self) -> dict:
        """The span-identity fields every xray tracer event carries."""
        args = {"trace_id": self.trace_id, "span_id": self.span_id}
        if self.parent_id:
            args["parent_span_id"] = self.parent_id
        return args

    def __repr__(self):
        return (f"SpanContext(trace={self.trace_id}, span={self.span_id}, "
                f"parent={self.parent_id})")

    def __eq__(self, other):
        return (isinstance(other, SpanContext)
                and self.trace_id == other.trace_id
                and self.span_id == other.span_id
                and self.parent_id == other.parent_id
                and (self.baggage or {}) == (other.baggage or {}))


# ids need uniqueness, not unpredictability: a PRNG seeded once from the
# OS beats an os.urandom syscall per id on the serve hot path (every
# request allocates 2+ span ids; the horizon bench prices this). Seeded
# lazily PER PROCESS KEYED ON PID so a fork between imports can't make
# two processes' id streams collide.
_rng_pid: Optional[int] = None
_rng: Optional[random.Random] = None


def _get_rng() -> random.Random:
    global _rng, _rng_pid
    if _rng is None or _rng_pid != os.getpid():
        _rng = random.Random(int.from_bytes(os.urandom(16), "big"))
        _rng_pid = os.getpid()
    return _rng


def new_trace_id() -> str:
    return f"{_get_rng().getrandbits(128):032x}"


def new_span_id() -> str:
    return f"{_get_rng().getrandbits(64):016x}"


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
    kill switch degrades the whole plane to legacy frames + no spans."""
    if not _trace_on():
        return None
    if parent is None and inherit:
        parent = current()
    if parent is not None:
        return parent.child()
    return SpanContext()


@contextlib.contextmanager
def activate(ctx: Optional[SpanContext]):
    """Make `ctx` the ambient context for the body (server handlers
    adopting a remote parent; executor threads adopting a request's)."""
    token = _cv.set(ctx)
    try:
        yield ctx
    finally:
        _cv.reset(token)


def set_current(ctx: Optional[SpanContext]):
    """Non-context-manager activation: returns a token for
    `unset_current`. The serve executor's batch loop uses this pair
    instead of `activate` — a generator context manager costs a few
    microseconds per batch, which the horizon A/B prices. Prefer
    `activate` anywhere that doesn't run per-request."""
    return _cv.set(ctx)


def unset_current(token):
    _cv.reset(token)


@contextlib.contextmanager
def span(name: str, cat: str = "xray", parent: Optional[SpanContext] = None,
         **args):
    """Timed span recorded into the tracer ring WITH trace identity.

    Like `Tracer.span` but each event carries trace_id/span_id/
    parent_span_id, and the new context is ambient for the body so
    nested spans (and outbound RPCs) join the trace. The event is
    recorded even when the body raises, tagged ``error=<type>``.

    With the `trace` flag off the body runs with no ids allocated, no
    ambient context, and nothing recorded — the yielded value is None."""
    ctx = child_of(parent)
    if ctx is None:
        yield None
        return
    ts = time.time()
    t0 = time.perf_counter()
    err = None
    token = _cv.set(ctx)
    try:
        yield ctx
    except BaseException as e:
        err = type(e).__name__
        raise
    finally:
        _cv.reset(token)
        if err is not None:
            args = dict(args, error=err)
        _tracer.get_tracer().record_ctx(name, ts, time.perf_counter() - t0,
                                        cat, ctx, args)


def record_span(name: str, ctx: Optional[SpanContext], ts: float,
                dur: float, cat: str = "xray", **args):
    """Append an already-timed span under an explicit context (callers
    that measured the region themselves, e.g. per-attempt RPC timing).
    A None ctx (trace flag off) is a no-op."""
    if ctx is None:
        return
    return _tracer.get_tracer().record_ctx(name, ts, dur, cat, ctx, args)


def tracer():
    """The process tracer (hot-path callers that record straight via
    `Tracer.record_ctx` without the record_span null-check hop)."""
    return _tracer.get_tracer()


# -- wire format ------------------------------------------------------------

def to_traceparent(ctx: SpanContext) -> str:
    return f"00-{ctx.trace_id}-{ctx.span_id}-01"


def parse_traceparent(value) -> Optional[SpanContext]:
    """Parse a ``traceparent`` string; any malformation returns None (a
    legacy or buggy peer must degrade to "no parent", never to an
    error)."""
    if not isinstance(value, str):
        return None
    parts = value.split("-")
    if len(parts) != 4:
        return None
    _ver, trace_id, span_id, _flags = parts
    if len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        int(trace_id, 16), int(span_id, 16)
    except ValueError:
        return None
    return SpanContext(trace_id, span_id)


def to_wire(ctx: SpanContext) -> dict:
    meta = {_WIRE_KEY: to_traceparent(ctx)}
    if ctx.baggage:
        meta[_BAGGAGE_KEY] = dict(ctx.baggage)
    return meta


def from_wire(meta) -> Optional[SpanContext]:
    """Extract a remote parent context from an RPC frame's meta dict.
    Missing/malformed -> None (legacy peer interop). Baggage survives
    the hop when present and well-formed (a str->str dict, bounded to
    `_BAGGAGE_MAX` entries — a hostile/buggy peer cannot bloat every
    downstream frame)."""
    if not isinstance(meta, dict):
        return None
    ctx = parse_traceparent(meta.get(_WIRE_KEY))
    if ctx is None:
        return None
    bag = meta.get(_BAGGAGE_KEY)
    if isinstance(bag, dict) and bag:
        clean = {str(k): str(v) for k, v in list(bag.items())[:_BAGGAGE_MAX]}
        ctx = SpanContext(ctx.trace_id, ctx.span_id, ctx.parent_id,
                          baggage=clean)
    return ctx


def baggage(key: Optional[str] = None):
    """The ambient context's baggage dict (or one value by `key`);
    empty/None when there is no ambient trace."""
    ctx = current()
    bag = (ctx.baggage or {}) if ctx is not None else {}
    return bag.get(key) if key is not None else bag


# -- process naming (chrome-trace merge) ------------------------------------

def set_process_name(name: str):
    """Name this process in chrome-trace exports (`tools/telemetry_dump.py
    --merge` stitches per-process files; the name is what perfetto shows
    per track)."""
    _tracer.set_process_name(name)


def process_name() -> str:
    return _tracer.get_process_name()


def reset():
    """Drop the ambient context of THIS thread (tests)."""
    _cv.set(None)

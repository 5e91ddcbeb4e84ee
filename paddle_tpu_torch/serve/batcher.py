"""Request batching for serving: `MicroBatcher` (one-shot models) and
`SlotScheduler` (generative models).

Mirror of ``paddle_tpu/serve/batcher.py``. A step on the card has a
near-constant host and launch cost whether it computes 1 row or 32, so
serving throughput is won by running FEWER, FULLER steps. Per (model,
group-signature) queues hold planned requests; a dedicated executor
thread per model coalesces a queue's requests up to the ladder's largest
rung or until the oldest request has waited `batch_timeout_ms`, pads the
coalesced rows up to a bucket rung, runs ONE prepared step, and
de-multiplexes the output rows back onto each caller's Future. The
fetches come back to the host once a batch (one device-to-host copy a
fetch) and are sliced by rows there.

Admission control is a bounded queue with fast-reject: a request that
arrives when `max_queue` requests are already waiting fails immediately
with the retriable QueueFullError — callers get backpressure in
microseconds instead of a timeout later. Each request may carry a
deadline; a request whose deadline expires while queued is dropped with
DeadlineExceededError without ever occupying the card.

The executor thread launches the batch's device work on that thread's
current CUDA stream. A CUDA error inside the step reaches every request
of the batch as the Future's exception; nothing retries on the host.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Dict, List, Optional, Tuple

from .. import flags as _flags
from ..observe import metrics as _metrics
from ..observe import xray as _xray
from .bucketing import concat_requests, pad_rows, plan_request
from .errors import (BadRequestError, DeadlineExceededError,
                     ModelUnavailableError, QueueFullError, ServeError)

# observe-flag probe for submit(), memoized on the flag registry version
# (same idiom as xray._trace_on): submit runs once per request
_observe_cache = (-1, False)


def _observe_on() -> bool:
    global _observe_cache
    ver = _flags.version()
    cached = _observe_cache
    if cached[0] != ver:
        cached = _observe_cache = (ver, bool(_flags.get_flag("observe")))
    return cached[1]


class _Request:
    __slots__ = ("planned", "future", "deadline", "t_enq", "ctx", "ts_wall")

    def __init__(self, planned, future, deadline, ctx=None, ts_wall=0.0):
        self.planned = planned
        self.future = future
        self.deadline = deadline        # absolute monotonic s, or None
        self.t_enq = time.monotonic()
        # observe on: the request's span context, captured
        # on the SUBMITTING thread so the whole queue->batch->de-mux
        # lifecycle lands in the caller's trace even though it completes
        # on the executor thread
        self.ctx = ctx
        self.ts_wall = ts_wall


class SlotScheduler:
    """Fixed-slot admission for multi-step generative work.

    One-shot inference coalesces a QUEUE into a batch and the batch
    drains atomically; a generative batch never drains atomically —
    sequences finish at wildly different steps. The scheduler therefore
    tracks a fixed array of SLOTS (the decode step's batch rows): a
    finished sequence vacates its slot mid-batch and the next queued
    request is admitted into the hole without stopping the slots still
    running — CONTINUOUS batching. `admission="drain"` is the deliberate
    strawman (refill only when every slot is empty — the classic
    drain-and-refill baseline).

    Admission control mirrors MicroBatcher: a bounded pending queue with
    fast-reject (QueueFullError) and queued-deadline expiry. The decode
    engine owns WHAT runs in a slot; the scheduler owns which slots run.
    """

    def __init__(self, n_slots: int, max_queue: int = 256,
                 admission: str = "continuous"):
        if admission not in ("continuous", "drain"):
            raise ValueError(
                f"admission must be 'continuous' or 'drain', "
                f"got {admission!r}")
        self.n_slots = int(n_slots)
        self.admission = admission
        self.max_queue = int(max_queue)
        self.cond = threading.Condition()
        self.slots: List[Optional[object]] = [None] * self.n_slots
        self.pending: deque = deque()

    # -- producer side (locked by callers via self.cond) ------------------

    def submit_locked(self, item) -> None:
        if len(self.pending) >= self.max_queue:
            raise QueueFullError(
                f"{len(self.pending)} generations already queued "
                f"(max_queue={self.max_queue}) — retry with backoff")
        self.pending.append(item)
        self.cond.notify_all()

    # -- engine side ------------------------------------------------------

    def active_count(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    def expire_locked(self, predicate) -> List[object]:
        """Pop every pending item for which `predicate(item)` is true
        (queued-deadline sweep)."""
        dead = [r for r in self.pending if predicate(r)]
        if dead:
            self.pending = deque(r for r in self.pending
                                 if not predicate(r))
        return dead

    # continuous-admission hysteresis: at full occupancy roughly one slot
    # frees per decode step, and admitting it alone costs a whole
    # single-row prefill step per decode step — measured to HALVE decode
    # throughput at deep-queue saturation. Waiting for a 2-slot admission
    # batch amortizes the prefill without hurting the underutilized case
    # (when fewer requests than this are waiting, admission is immediate).
    ADMIT_BATCH = 2

    def admissible_locked(self) -> List[int]:
        """Free slot indices the policy allows filling right now."""
        free = [i for i, s in enumerate(self.slots) if s is None]
        if not self.pending or not free:
            return []
        if self.admission == "drain" and self.active_count():
            return []     # the strawman: wait for the whole batch
        want = min(self.ADMIT_BATCH, len(self.pending), self.n_slots)
        if self.admission == "continuous" and len(free) < want:
            return []     # let a small admission batch accumulate
        return free

    def occupy_locked(self, slot: int, state) -> None:
        assert self.slots[slot] is None
        self.slots[slot] = state

    def vacate_locked(self, slot: int) -> None:
        self.slots[slot] = None
        self.cond.notify_all()

    def resize_locked(self, n_slots: int) -> None:
        """Rebind-time resize (hot swap to a version with a different
        max_slots); only legal while every slot is vacant."""
        assert self.active_count() == 0
        self.n_slots = int(n_slots)
        self.slots = [None] * self.n_slots


class MicroBatcher:
    """One model's queues + executor thread."""

    def __init__(self, registry, name: str, batch_timeout_ms: float = 2.0,
                 max_queue: int = 256):
        self._registry = registry
        self._name = name
        self._timeout_s = max(batch_timeout_ms, 0.0) / 1e3  # guarded_by: self._cond
        self._max_queue = max_queue
        self._queues: Dict[Tuple, deque] = {}  # guarded_by: self._cond
        self._cond = threading.Condition()
        self._pending = 0  # guarded_by: self._cond
        self._closed = False  # guarded_by: self._cond
        self._m_requests = _metrics.counter(
            "serve_requests_total", "serving requests by outcome")
        self._m_rejects = _metrics.counter(
            "serve_rejects_total", "fast-rejected requests by reason")
        self._m_latency = _metrics.histogram(
            "serve_request_latency_us", "enqueue->result per request")
        self._m_batch_latency = _metrics.histogram(
            "serve_batch_latency_us", "prepared step wall per batch")
        self._m_occupancy = _metrics.histogram(
            "serve_batch_occupancy", "requests coalesced per batch")
        self._m_rows = _metrics.histogram(
            "serve_batch_rows", "real (unpadded) rows per batch")
        self._m_waste = _metrics.histogram(
            "serve_padding_waste_ratio",
            "padded-but-dead row fraction per batch")
        self._m_bucket = _metrics.counter(
            "serve_bucket_fills_total",
            "batches by bucket fit (exact = no row padding)")
        self._m_depth = _metrics.gauge(
            "serve_queue_depth", "requests waiting, per model")
        # depth AND capacity, so a reader can compute saturation per model
        self._m_qcap = _metrics.gauge(
            "serve_queue_capacity", "admission-control bound, per model")
        self._m_qcap.set(self._max_queue, model=name)
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name=f"serve-exec-{name}")
        self._thread.start()

    # -- producer side ---------------------------------------------------

    def submit(self, feed, deadline_ms: Optional[float] = None) -> Future:
        """Plan, admit and enqueue one request; returns its Future."""
        ctx = _xray.child_of() if _observe_on() else None
        ts_wall = time.time() if ctx is not None else 0.0
        t_sub = time.monotonic()
        # cheap pre-check BEFORE planning: under overload the fast-reject
        # must not pay plan_request's pad/cast array copies per bounced
        # request (the authoritative check re-runs under the lock below)
        if self._pending >= self._max_queue:  # race_lint: ignore[unguarded-read] — benign racy fast-path; authoritative re-check under the lock below
            self._reject_span(ctx, ts_wall, t_sub, "queue_full")
            self._reject_full()
        ver = self._registry.get(self._name)
        planned = plan_request(ver.spec, ver.ladder, feed)
        fut: Future = Future()
        deadline = (time.monotonic() + deadline_ms / 1e3
                    if deadline_ms is not None else None)
        req = _Request(planned, fut, deadline, ctx, ts_wall)
        with self._cond:
            if self._closed:
                self._reject_span(ctx, ts_wall, t_sub, "unavailable")
                raise ModelUnavailableError(
                    f"model {self._name!r}: batcher is shut down")
            if self._pending >= self._max_queue:
                self._reject_span(ctx, ts_wall, t_sub, "queue_full")
                self._reject_full()
            self._queues.setdefault(planned.group_key, deque()).append(req)
            self._pending += 1
            self._m_depth.set(self._pending, model=self._name)
            self._cond.notify()
        return fut

    def _reject_span(self, ctx, ts_wall, t_sub, outcome: str):
        """Close the lifecycle span of a request rejected at admission —
        rejections must be visible in the caller's trace, not only in
        the serve_requests_total counter."""
        if ctx is not None:
            _xray.record_span("serve_request", ctx, ts_wall,
                              time.monotonic() - t_sub, cat="serve",
                              model=self._name, outcome=outcome)

    def _reject_full(self):
        self._m_rejects.inc(model=self._name, reason="queue_full")
        self._m_requests.inc(model=self._name, outcome="queue_full")
        raise QueueFullError(
            f"model {self._name!r}: {self._pending} requests "  # race_lint: ignore[unguarded-read] — depth in the error text may be stale by one tick; harmless
            f"already queued (max_queue={self._max_queue}) — "
            f"retry with backoff")

    def queue_depth(self) -> int:
        with self._cond:
            return self._pending

    def _fail(self, req: _Request, exc: ServeError, outcome: str):
        """Fail a request that never ran, tolerating a client cancel():
        transitioning the Future to RUNNING first means set_exception can
        no longer race an InvalidStateError out of the executor thread."""
        if req.future.set_running_or_notify_cancel():
            self._m_requests.inc(model=self._name, outcome=outcome)
            self._req_span(req, outcome)
            req.future.set_exception(exc)
        else:
            self._m_requests.inc(model=self._name, outcome="cancelled")

    def _req_span(self, req: _Request, outcome: str, batch_span=None,
                  **args):
        """Close the request's lifecycle span (submit -> resolution).
        Records straight into the tracer ring (no record_span hop) —
        this runs once per served request on the executor thread,
        BEFORE the future resolves, so every microsecond here delays
        the caller's wakeup."""
        if req.ctx is not None:
            extra = {"model": self._name, "outcome": outcome,
                     "rows": req.planned.rows}
            if batch_span is not None:
                extra["batch_span"] = batch_span
            if args:
                extra.update(args)
            _xray.tracer().record_ctx(
                "serve_request", req.ts_wall,
                time.monotonic() - req.t_enq, "serve", req.ctx, extra)

    # -- executor side ---------------------------------------------------

    def _expire_locked(self, now: float) -> List[_Request]:
        """Pop every queued request whose deadline has passed."""
        dead: List[_Request] = []
        for key in list(self._queues):
            kept: deque = deque()
            for r in self._queues[key]:
                if r.deadline is not None and r.deadline <= now:
                    dead.append(r)
                else:
                    kept.append(r)
            if kept:
                self._queues[key] = kept
            else:
                del self._queues[key]
        self._pending -= len(dead)
        return dead

    def _pop_ready_locked(self, now: float, max_rows: int
                          ) -> Optional[List[_Request]]:
        """Pop a coalesced batch from the oldest-headed READY queue — one
        with enough rows to fill the top rung, or whose head has aged
        past batch_timeout. A full queue runs immediately even while an
        older lone request in another queue is still inside its window."""
        best_key, best_t = None, None
        for key, q in self._queues.items():
            if not q:
                continue
            rows_avail = 0
            for r in q:
                rows_avail += r.planned.rows
                if rows_avail >= max_rows:
                    break
            if rows_avail < max_rows \
                    and now - q[0].t_enq < self._timeout_s:
                continue
            if best_t is None or q[0].t_enq < best_t:
                best_key, best_t = key, q[0].t_enq
        if best_key is None:
            return None
        q = self._queues[best_key]
        batch: List[_Request] = []
        rows = 0
        while q and rows + q[0].planned.rows <= max_rows:
            r = q.popleft()
            batch.append(r)
            rows += r.planned.rows
        if not q:
            del self._queues[best_key]
        self._pending -= len(batch)
        return batch or None

    def _next_wakeup_locked(self, now: float) -> Optional[float]:
        """Seconds until the earliest head matures or ANY queued
        request's deadline expires (a non-head deadline must wake the
        expiry sweep too)."""
        t = None
        for q in self._queues.values():
            if not q:
                continue
            due = q[0].t_enq + self._timeout_s
            for r in q:
                if r.deadline is not None:
                    due = min(due, r.deadline)
            t = due if t is None else min(t, due)
        if t is None:
            return None
        return max(t - now, 1e-4)

    def _loop(self):
        while True:
            with self._cond:
                while not self._closed and self._pending == 0:
                    self._cond.wait()
                if self._closed:
                    return
                now = time.monotonic()
                expired = self._expire_locked(now)
                batch = None
                if self._pending:
                    try:
                        max_rows = self._registry.get(
                            self._name).ladder.max_rows
                    except ServeError:
                        max_rows = 1
                    batch = self._pop_ready_locked(now, max_rows)
                    if batch is None and not expired:
                        self._cond.wait(self._next_wakeup_locked(now))
                self._m_depth.set(self._pending, model=self._name)
            for r in expired:
                self._m_rejects.inc(model=self._name, reason="deadline")
                self._fail(r, DeadlineExceededError(
                    f"model {self._name!r}: deadline expired after "
                    f"{(time.monotonic() - r.t_enq) * 1e3:.1f} ms in "
                    f"queue"), "deadline")
            if batch:
                self._execute(batch)

    def _execute(self, batch: List[_Request]):
        # claim every Future up front: a client cancel() that landed
        # while the request was queued drops it here; after this point
        # set_result/set_exception cannot hit a CANCELLED future
        claimed: List[_Request] = []
        for r in batch:
            if r.future.set_running_or_notify_cancel():
                claimed.append(r)
            else:
                self._m_requests.inc(model=self._name, outcome="cancelled")
        batch = claimed
        if not batch:
            return
        try:
            ver = self._registry.acquire(self._name)
        except ServeError as e:
            for r in batch:
                self._m_requests.inc(model=self._name, outcome="error")
                r.future.set_exception(e)
            return
        try:
            # a hot swap may have SHRUNK the ladder after these requests
            # were admitted: re-chunk the coalesced batch to the acquired
            # version's top rung so valid-when-admitted requests still
            # run; only a single request too big for the new ladder fails
            max_rows = ver.ladder.max_rows
            chunk: List[_Request] = []
            chunk_rows = 0
            for r in batch:
                if r.planned.rows > max_rows:
                    # already RUNNING (claimed above) — safe to set
                    self._m_requests.inc(model=self._name, outcome="error")
                    self._req_span(r, "error", error="BadRequestError")
                    r.future.set_exception(BadRequestError(
                        f"model {self._name!r}: request has "
                        f"{r.planned.rows} rows but a hot swap shrank "
                        f"the ladder to max {max_rows}"))
                    continue
                if chunk and chunk_rows + r.planned.rows > max_rows:
                    self._run_chunk(ver, chunk)
                    chunk, chunk_rows = [], 0
                chunk.append(r)
                chunk_rows += r.planned.rows
            if chunk:
                self._run_chunk(ver, chunk)
        finally:
            self._registry.release(ver)

    def _run_chunk(self, ver, batch: List[_Request]):
        try:
            feeds, rows = concat_requests([r.planned for r in batch])
            target = ver.ladder.rows_rung(rows)
            padded = pad_rows(feeds, rows, target)
            # the batch span: the ONE prepared step serving these
            # coalesced requests. Parented to the oldest request's trace
            # (the one that waited longest for this batch); the other
            # members are linked through `traces` and each request's own
            # lifecycle span carries `batch_span` back to it. Computed
            # BEFORE the sparse augment and made AMBIENT around it: the
            # augment's PSClient row pulls run on THIS executor thread,
            # and without the activation they would start fresh traces
            # instead of joining the router -> replica -> pserver chain
            bctx = None
            for r in batch:
                if r.ctx is not None:
                    bctx = _xray.child_of(r.ctx)
                    break
            # the activation exists FOR the sparse augment's PSClient
            # spans; a dense model runs nothing that reads the ambient
            # context, so skip the ContextVar set/reset on its hot path
            token = (_xray.set_current(bctx)
                     if bctx is not None and ver.sparse_plan is not None
                     else None)
            try:
                if ver.sparse_plan is not None:
                    # pull this BATCH's unique embedding rows from the
                    # pserver shards (row cache first) and feed them as
                    # fixed-shape sub-tables with ids remapped — after
                    # padding, so the fed shapes match the warmed ones
                    padded = ver.sparse_plan.augment(padded)
                ts_wall = time.time()
                t0 = time.perf_counter()
                # numpy fetches: one device-to-host copy a fetch, for the
                # whole padded batch; the rows are sliced on the host
                fetches = ver.prepared.run(padded)
                dt = time.perf_counter() - t0
            finally:
                if token is not None:
                    _xray.unset_current(token)
            # a version loaded with warm=False becomes "warmed" by
            # serving
            ver.warmed = True
            if bctx is not None:
                extra = {"model": self._name, "requests": len(batch),
                         "rows": rows, "padded_rows": target}
                if len(batch) > 1:
                    # cross-links to the other members' traces — when
                    # there IS more than one (a lone request's trace is
                    # already the batch span's parent)
                    extra["traces"] = [r.ctx.trace_id for r in batch[:8]
                                       if r.ctx is not None]
                _xray.tracer().record_ctx("serve_batch", ts_wall, dt,
                                          "serve", bctx, extra)
            self._m_batch_latency.observe(dt * 1e6, model=self._name)
            self._m_occupancy.observe(len(batch), model=self._name)
            self._m_rows.observe(rows, model=self._name)
            self._m_waste.observe((target - rows) / target,
                                  model=self._name)
            self._m_bucket.inc(model=self._name,
                               fit="exact" if target == rows else "padded")
            done = time.monotonic()
            offset = 0
            for r in batch:
                n = r.planned.rows
                outs = [f[offset:offset + n]
                        if getattr(f, "ndim", 0) >= 1
                        and f.shape[0] == target else f
                        for f in fetches]
                offset += n
                self._m_requests.inc(model=self._name, outcome="ok")
                self._m_latency.observe((done - r.t_enq) * 1e6,
                                        model=self._name)
                # batch_span back-links a request to the batch it rode in
                # — only meaningful when it shared the batch (at
                # occupancy 1 the request's own span is the batch span's
                # parent)
                self._req_span(
                    r, "ok",
                    batch_span=(bctx.span_id
                                if bctx is not None and len(batch) > 1
                                else None))
                # tag the resolving Future with the version that actually
                # EXECUTED this request: a swap under traffic shows which
                # version served each response
                r.future.version_id = ver.version_id
                r.future.version_key = ver.version_key
                r.future.set_result(outs)
        except Exception as e:
            for r in batch:
                self._m_requests.inc(model=self._name, outcome="error")
                if not r.future.done():
                    self._req_span(r, "error", error=type(e).__name__)
                    r.future.set_exception(e)

    def reconfigure(self, batch_timeout_ms: Optional[float] = None,
                    max_queue: Optional[int] = None):
        """Apply new batcher settings to the live queues (used when
        add_model re-registers an existing name with explicit values)."""
        with self._cond:
            if batch_timeout_ms is not None:
                self._timeout_s = max(batch_timeout_ms, 0.0) / 1e3
            if max_queue is not None:
                self._max_queue = max_queue
                self._m_qcap.set(max_queue, model=self._name)
            self._cond.notify_all()

    def close(self):
        """Stop the executor thread and fail everything still queued."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            dead = [r for q in self._queues.values() for r in q]
            self._queues.clear()
            self._pending = 0
            # zero the depth gauge too: a frozen last-high value would
            # keep the registry-driven saturation detector firing on a
            # queue that no longer exists
            self._m_depth.set(0, model=self._name)
            self._cond.notify_all()
        for r in dead:
            self._fail(r, ModelUnavailableError(
                f"model {self._name!r}: batcher shut down with the "
                f"request still queued"), "error")
        self._thread.join(timeout=5)

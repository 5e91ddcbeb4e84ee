"""The autoregressive serving engine.

Mirror of ``paddle_tpu/serve/decode.py`` (`DecodeEngine`: submit,
generate, the engine loop, admission + prefill, the decode step, finish).
A generative request runs one PREFILL step plus up to max_new_tokens - 1
DECODE steps:

- **Prefill** rides the bucket ladder: admitted prompts are grouped by
  their padded-length rung, batched up to the rows rung, and run through
  the prefill program (causal flash attention + paged KV cache write).
  The first token comes from prefill's last-position logits (TTFT).
- **Decode** is a fixed-slot step: every iteration runs ONE step of
  shape [max_slots] however many slots are live (inactive slots attend to
  nothing and write to the trash block).
- **Continuous batching** (serve/batcher.py SlotScheduler): a finished
  sequence vacates its slot between steps and a queued request is
  prefilled into the hole while the other slots keep decoding.

Sampling is greedy argmax on the host: the logits come back to the host
each step (max_slots x vocab float32), so generations are deterministic
and comparable token for token. KV capacity is reserved worst-case at
admission (serve/kvcache.py).

The engine thread launches the device work of every step, on that
thread's current CUDA stream. Over an int8 cache (signature
`kv_dtype="int8"`) the decode step counts whole-block requantize events
in a [1] int32 scope var on the device; the engine reads it once a step
and publishes the delta as ``serve_kv_requant_events_total``.

Hot swap: sequences in flight finish on the version they started on (the
engine holds a registry refcount while any slot is live, and releases it
whenever it goes idle); when a new version is published the engine stops
admitting, lets the active slots drain on the old version, releases it
and binds the new one — the swap costs one drain, never a wrong-version
token. With the `observe` flag on, each generation closes a
``serve_generate`` span. KV export/import between replicas (and with it
requantize-on-admit) is not ported.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as _FuturesTimeout
from typing import Dict, List, Optional, Sequence

import numpy as np

from .. import flags as _flags
from ..observe import metrics as _metrics
from ..observe import xray as _xray
from .batcher import SlotScheduler
from .errors import (BadRequestError, CacheExhaustedError,
                     DeadlineExceededError, ModelUnavailableError,
                     QueueFullError, ServeError)

_STREAM_END = object()


class GenerationResult:
    """What a finished generation resolves to."""

    __slots__ = ("tokens", "prompt_len", "finish_reason", "ttft_us",
                 "version_id")

    def __init__(self, tokens, prompt_len, finish_reason, ttft_us,
                 version_id):
        self.tokens = tokens              # generated tokens (no prompt)
        self.prompt_len = prompt_len
        self.finish_reason = finish_reason  # "eos" | "length"
        self.ttft_us = ttft_us
        self.version_id = version_id

    def __repr__(self):
        return (f"GenerationResult({len(self.tokens)} tokens, "
                f"{self.finish_reason!r}, ttft {self.ttft_us:.0f}us)")


class GenerationStream:
    """submit_stream handle: iterate tokens as they are produced; the
    future resolves to the full GenerationResult (or the error)."""

    def __init__(self, future: Future):
        self.future = future
        self._q: "queue.Queue" = queue.Queue()

    def _push(self, tok):
        self._q.put(tok)

    def _finish(self):
        self._q.put(_STREAM_END)

    def __iter__(self):
        while True:
            t = self._q.get()
            if t is _STREAM_END:
                return
            yield t


class _GenRequest:
    __slots__ = ("prompt", "max_new", "future", "stream", "deadline",
                 "t_enq", "ctx", "ts_wall", "resolved")

    def __init__(self, prompt, max_new, future, stream, deadline, ctx,
                 ts_wall):
        self.prompt = prompt
        self.max_new = max_new
        self.future = future
        self.stream = stream
        self.deadline = deadline          # absolute monotonic s or None
        self.t_enq = time.monotonic()
        self.ctx = ctx                    # span context (observe on)
        self.ts_wall = ts_wall
        self.resolved = False             # guarded by the engine cond


class _Slot:
    """Slot state. Occupies its scheduler slot from ADMISSION; `started`
    flips once prefill produced the first token and decode may include
    the slot."""

    __slots__ = ("req", "ctx_len", "last_token", "generated", "ttft_us",
                 "started")

    def __init__(self, req):
        self.req = req
        self.ctx_len = 0                  # tokens whose K/V are in cache
        self.last_token = -1              # next decode step's input
        self.generated: List[int] = []
        self.ttft_us = 0.0
        self.started = False


class DecodeEngine:
    """One generative model's slots + engine thread."""

    def __init__(self, registry, name: str, max_queue: int = 256,
                 admission: str = "continuous"):
        self._registry = registry
        self._name = name
        self._requant_seen = 0            # engine thread only
        sig = registry.get(name).decode.signature
        self._sched = SlotScheduler(sig["max_slots"], max_queue=max_queue,
                                    admission=admission)
        self._cond = self._sched.cond
        self._ver = None                  # acquired while slots are live
        self._closed = False
        self._m_requant = _metrics.counter(
            "serve_kv_requant_events_total",
            "int8 KV whole-block requantize events, per model")
        self._m_requests = _metrics.counter(
            "serve_generate_requests_total",
            "generative requests by outcome")
        self._m_tokens = _metrics.counter(
            "serve_decode_tokens_total", "tokens generated, per model")
        self._m_ttft = _metrics.histogram(
            "serve_ttft_us", "submit -> first token per generation")
        self._m_steps = _metrics.counter(
            "serve_decode_steps_total", "fixed-slot decode steps run")
        self._m_occupancy = _metrics.histogram(
            "serve_decode_occupancy", "live slots per decode step")
        self._m_step_latency = _metrics.histogram(
            "serve_decode_step_us", "decode step wall time")
        self._m_prefill_latency = _metrics.histogram(
            "serve_prefill_us", "prefill step wall time")
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name=f"serve-decode-{name}")
        self._thread.start()

    # -- producer side ----------------------------------------------------

    def submit(self, prompt: Sequence[int], max_new_tokens: int = 16,
               deadline_ms: Optional[float] = None, stream: bool = False):
        """Enqueue one generation. Returns its Future (stream=False) or a
        GenerationStream (stream=True). Rejections are immediate:
        QueueFullError / CacheExhaustedError are retriable backpressure,
        BadRequestError means the prompt can never run."""
        ver = self._registry.get(self._name)
        if ver.decode is None:
            raise BadRequestError(
                f"model {self._name!r} has no decode program — "
                f"a one-shot model cannot generate")
        sig = ver.decode.signature
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise BadRequestError("empty prompt")
        if any(t < 0 or t >= sig["vocab"] for t in prompt):
            raise BadRequestError(
                f"prompt token out of range for vocab {sig['vocab']}")
        max_rung = max(sig["prefill_seq_rungs"])
        if len(prompt) > max_rung:
            raise BadRequestError(
                f"prompt of {len(prompt)} tokens exceeds the largest "
                f"prefill rung {max_rung}")
        max_new = int(max_new_tokens)
        if max_new < 1:
            raise BadRequestError("max_new_tokens must be >= 1")
        if len(prompt) + max_new > sig["max_context"]:
            raise BadRequestError(
                f"prompt {len(prompt)} + max_new_tokens {max_new} "
                f"exceeds max_context {sig['max_context']}")
        ctx = _xray.child_of() if _flags.get_flag("observe") else None
        ts_wall = time.time() if ctx is not None else 0.0
        fut: Future = Future()
        gstream = GenerationStream(fut) if stream else None
        deadline = (time.monotonic() + deadline_ms / 1e3
                    if deadline_ms is not None else None)
        req = _GenRequest(prompt, max_new, fut, gstream, deadline, ctx,
                          ts_wall)
        with self._cond:
            if self._closed:
                raise ModelUnavailableError(
                    f"model {self._name!r}: decode engine is shut down")
            try:
                self._sched.submit_locked(req)
            except QueueFullError:
                self._m_requests.inc(model=self._name,
                                     outcome="queue_full")
                raise QueueFullError(
                    f"model {self._name!r}: "
                    f"{len(self._sched.pending)} generations queued "
                    f"(max_queue={self._sched.max_queue}) — retry with "
                    f"backoff") from None
        return gstream if stream else fut

    def generate(self, prompt, max_new_tokens: int = 16,
                 deadline_ms: Optional[float] = None) -> GenerationResult:
        fut = self.submit(prompt, max_new_tokens=max_new_tokens,
                          deadline_ms=deadline_ms)
        if deadline_ms is None:
            return fut.result()
        # _FuturesTimeout: on Python < 3.11 concurrent.futures raises its
        # OWN TimeoutError class, not the builtin
        try:
            return fut.result(timeout=deadline_ms / 1e3 + 30.0)
        except (TimeoutError, _FuturesTimeout):
            raise DeadlineExceededError(
                f"model {self._name!r}: no generation result within "
                f"deadline {deadline_ms} ms (+30 s slack)") from None

    def stats(self) -> dict:
        with self._cond:
            active = self._sched.active_count()
            pending = len(self._sched.pending)
        kv = None
        try:
            dec = self._registry.get(self._name).decode
            if dec is not None:
                kv = {"blocks_in_use": dec.kvcache.in_use(),
                      "blocks_capacity": dec.kvcache.capacity}
        except ServeError:
            pass
        ttft = self._m_ttft.summary(model=self._name)
        prefill = self._m_prefill_latency.summary(model=self._name)
        return {
            "active_slots": active,
            "queued": pending,
            "admission": self._sched.admission,
            "tokens": self._m_tokens.value(model=self._name),
            "steps": self._m_steps.value(model=self._name),
            "prefill_steps": prefill["count"] if prefill else 0,
            "avg_ttft_us": round(ttft["mean"], 1) if ttft else 0.0,
            "kv_requant_events": self._m_requant.value(model=self._name),
            "kv": kv,
        }

    # -- outcomes ---------------------------------------------------------

    def _finish_req(self, req: _GenRequest, outcome: str, result=None,
                    exc=None):
        # exactly-once: close() (caller thread) can race the engine
        # thread finishing the same request
        with self._cond:
            if req.resolved:
                return
            req.resolved = True
        self._m_requests.inc(model=self._name, outcome=outcome)
        if req.ctx is not None:
            _xray.record_span(
                "serve_generate", req.ctx, req.ts_wall,
                time.monotonic() - req.t_enq, cat="serve",
                model=self._name, outcome=outcome,
                prompt_len=len(req.prompt),
                tokens=len(result.tokens) if result is not None else 0)
        if req.stream is not None:
            req.stream._finish()
        if req.future.set_running_or_notify_cancel():
            if exc is not None:
                req.future.set_exception(exc)
            else:
                req.future.set_result(result)

    # -- engine loop ------------------------------------------------------

    def _loop(self):
        while True:
            with self._cond:
                while not self._closed and not self._sched.pending \
                        and self._sched.active_count() == 0:
                    # going idle releases the version pin so a swapped-out
                    # version can fully retire while no work is in flight
                    if self._ver is not None:
                        self._release_version()
                    self._cond.wait()
                if self._closed:
                    return
                now = time.monotonic()
                expired = self._sched.expire_locked(
                    lambda r: r.deadline is not None and r.deadline <= now)
            for r in expired:
                self._finish_req(r, "deadline", exc=DeadlineExceededError(
                    f"model {self._name!r}: generation deadline expired "
                    f"after {(time.monotonic() - r.t_enq) * 1e3:.1f} ms "
                    f"in queue"))
            try:
                self._rebind_if_needed()
                self._admit_and_prefill()
                self._decode_step()
                if self._ver is None:
                    # pending work but no servable version (registry
                    # closing): don't hot-spin — wake on the next
                    # submit/close or re-check shortly
                    with self._cond:
                        if not self._closed:
                            self._cond.wait(0.05)
            except Exception as e:          # noqa: BLE001
                # a broken step fails the sequences riding it, not the
                # engine thread; a persistent error must not hot-loop
                self._fail_all(e)
                with self._cond:
                    if not self._closed:
                        self._cond.wait(0.05)

    def _release_version(self):
        self._registry.release(self._ver)
        self._ver = None

    def _rebind_if_needed(self):
        """Bind the current published version when unbound; when a NEW
        version was published, stop admitting and let active sequences
        drain on the old one, then flip."""
        try:
            cur = self._registry.get(self._name)
        except ServeError:
            return
        if self._ver is None:
            self._ver = self._registry.acquire(self._name)
            self._requant_seen = 0        # fresh binding, fresh counter
            with self._cond:
                if self._sched.n_slots != \
                        self._ver.decode.signature["max_slots"]:
                    self._sched.resize_locked(
                        self._ver.decode.signature["max_slots"])
            return
        if cur.version_id != self._ver.version_id:
            with self._cond:
                active = self._sched.active_count()
            if active == 0:
                self._release_version()
                self._rebind_if_needed()

    def _swap_pending(self) -> bool:
        """True while a newer version is published than the one bound —
        admission pauses so the bound version can drain."""
        if self._ver is None:
            return False
        try:
            return self._registry.get(self._name).version_id \
                != self._ver.version_id
        except ServeError:
            return False

    # -- admission + prefill ----------------------------------------------

    def _admit_and_prefill(self):
        if self._ver is None or self._swap_pending():
            return
        dec = self._ver.decode
        sig = dec.signature
        admitted: List = []               # (slot, _Slot)
        rejected = None
        with self._cond:
            for slot in self._sched.admissible_locked():
                if not self._sched.pending:
                    break
                req = self._sched.pending[0]
                try:
                    dec.kvcache.reserve(slot, len(req.prompt) + req.max_new)
                except CacheExhaustedError as e:
                    if self._sched.active_count() == 0 and not admitted:
                        # nothing running will ever free blocks: this
                        # request can never be admitted — reject it
                        self._sched.pending.popleft()
                        rejected = (req, e)
                    break                 # backpressure: wait for frees
                self._sched.pending.popleft()
                state = _Slot(req)
                self._sched.occupy_locked(slot, state)
                admitted.append((slot, state))
        if rejected is not None:
            self._finish_req(rejected[0], "cache_exhausted",
                             exc=rejected[1])
        if not admitted:
            return
        # group by prompt-length rung; each group is one prefill step
        ladder = self._ver.ladder
        groups: Dict[int, List] = {}
        for slot, state in admitted:
            rung = ladder.dim_rung("tokens", 1, len(state.req.prompt))
            groups.setdefault(rung, []).append((slot, state))
        for rung, members in groups.items():
            for i in range(0, len(members), ladder.max_rows):
                self._prefill_chunk(dec, sig, rung,
                                    members[i:i + ladder.max_rows])

    def _prefill_chunk(self, dec, sig, rung: int, members: List):
        rows = self._ver.ladder.rows_rung(len(members))
        tokens = np.zeros((rows, rung), np.int64)
        seq_lens = np.zeros((rows,), np.int32)
        bt = np.zeros((rows, sig["max_blocks_per_seq"]), np.int32)
        for r, (slot, state) in enumerate(members):
            prompt = state.req.prompt
            tokens[r, :len(prompt)] = prompt
            seq_lens[r] = len(prompt)
            tables = dec.kvcache.ensure(slot, len(prompt))
            bt[r] = tables[slot]
        t0 = time.perf_counter()
        logits, = self._ver.prepared.run({
            "tokens": tokens, "block_tables": bt, "seq_lens": seq_lens})
        self._m_prefill_latency.observe(
            (time.perf_counter() - t0) * 1e6, model=self._name)
        # a warm=False version becomes "warmed" by serving
        self._ver.warmed = True
        done = time.monotonic()
        for r, (slot, state) in enumerate(members):
            tok = int(np.argmax(logits[r]))
            state.ttft_us = (done - state.req.t_enq) * 1e6
            self._m_ttft.observe(state.ttft_us, model=self._name)
            self._m_tokens.inc(model=self._name)
            state.ctx_len = len(state.req.prompt)
            state.last_token = tok
            state.generated = [tok]
            state.started = True
            if state.req.stream is not None:
                state.req.stream._push(tok)
            self._maybe_finish(slot, state, tok, sig)

    def _sample_requant(self, sig):
        """Meter int8 whole-block requantize events: the decode step
        increments the [1] int32 requant var on the device; the engine
        reads it (one int a step, beside the logits the step already
        copies) and publishes the delta. Engine thread only."""
        rq = sig.get("requant_var")
        if rq is None:
            return
        val = int(self._ver.scope.find_var(rq)[0])
        if val > self._requant_seen:
            self._m_requant.inc(val - self._requant_seen,
                                model=self._name)
        self._requant_seen = val

    # -- decode ------------------------------------------------------------

    def _decode_step(self):
        if self._ver is None:
            return
        dec = self._ver.decode
        sig = dec.signature
        with self._cond:
            live = [(i, s) for i, s in enumerate(self._sched.slots)
                    if s is not None and s.started]
        if not live:
            return
        S = self._sched.n_slots
        tokens = np.zeros((S, 1), np.int64)
        seq_lens = np.zeros((S,), np.int32)
        for i, s in live:
            dec.kvcache.ensure(i, s.ctx_len + 1)
            tokens[i, 0] = s.last_token
            seq_lens[i] = s.ctx_len + 1
        t0 = time.perf_counter()
        logits, = dec.prepared.run({
            "tokens": tokens,
            "block_tables": dec.kvcache.block_tables,
            "seq_lens": seq_lens})
        self._m_step_latency.observe(
            (time.perf_counter() - t0) * 1e6, model=self._name)
        self._m_steps.inc(model=self._name)
        self._m_occupancy.observe(len(live), model=self._name)
        self._sample_requant(sig)
        now = time.monotonic()
        for i, s in live:
            s.ctx_len += 1
            tok = int(np.argmax(logits[i]))
            s.generated.append(tok)
            s.last_token = tok
            self._m_tokens.inc(model=self._name)
            if s.req.stream is not None:
                s.req.stream._push(tok)
            if self._maybe_finish(i, s, tok, sig):
                continue
            if s.req.deadline is not None and now >= s.req.deadline:
                # mid-decode deadline: stop spending slot-steps on a
                # caller who has given up; streamed tokens were delivered
                self._vacate(i)
                self._finish_req(s.req, "deadline",
                                 exc=DeadlineExceededError(
                                     f"model {self._name!r}: generation "
                                     f"deadline expired after "
                                     f"{len(s.generated)} tokens"))

    def _maybe_finish(self, slot: int, s: _Slot, tok: int, sig) -> bool:
        eos = sig.get("eos_token")
        reason = None
        if eos is not None and tok == int(eos):
            reason = "eos"
        elif len(s.generated) >= s.req.max_new:
            reason = "length"
        if reason is None:
            return False
        self._vacate(slot)
        self._finish_req(s.req, "ok", result=GenerationResult(
            list(s.generated), len(s.req.prompt), reason, s.ttft_us,
            self._ver.version_id))
        return True

    def _vacate(self, slot: int):
        self._ver.decode.kvcache.free_slot(slot)
        with self._cond:
            self._sched.vacate_locked(slot)

    def _fail_all(self, exc: Exception):
        with self._cond:
            live = [(i, s) for i, s in enumerate(self._sched.slots)
                    if s is not None]
        for i, s in live:
            self._vacate(i)
            self._finish_req(s.req, "error", exc=exc)

    def close(self):
        with self._cond:
            if self._closed:
                return
            self._closed = True
            dead = list(self._sched.pending)
            self._sched.pending.clear()
            live = [(i, s) for i, s in enumerate(self._sched.slots)
                    if s is not None]
            for i, _ in live:
                self._sched.slots[i] = None
            self._cond.notify_all()
        exc = ModelUnavailableError(
            f"model {self._name!r}: decode engine shut down with the "
            f"generation in flight")
        for r in dead:
            self._finish_req(r, "error", exc=exc)
        for _, s in live:
            self._finish_req(s.req, "error", exc=exc)
        # join BEFORE freeing the killed sequences' blocks and dropping
        # the version pin: the loop may be mid-step on them
        self._thread.join(timeout=10)
        if self._ver is not None:
            # the version may keep serving (a kind-flip re-registration):
            # return the killed sequences' blocks
            for i, _ in live:
                self._ver.decode.kvcache.free_slot(i)
            self._release_version()

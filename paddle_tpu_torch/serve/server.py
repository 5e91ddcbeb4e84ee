"""InferenceServer: the in-process serving facade.

Mirror of ``paddle_tpu/serve/server.py``. Ties the registry
(hot-swappable warmed models) to one MicroBatcher per one-shot model and
one DecodeEngine per generative model:

    srv = serve.InferenceServer()                 # CUDAPlace(0)
    srv.add_model("ranker", "/models/ranker",
                  ladder=serve.BucketLadder(rows=(1, 2, 4, 8)))
    out, = srv.infer("ranker", {"x": batch})      # blocking
    fut  = srv.submit("ranker", {"x": batch})     # Future
    srv.add_model("lm", "/models/lm")             # a generative dir
    res = srv.generate("lm", prompt, max_new_tokens=32)

`infer` blocks on the request's Future; `submit` returns it so callers
can pipeline. Both take `deadline_ms`. A second `add_model` of a name,
`reload`, `prepare_swap` + `commit_swap`, and the dir watcher
(`start_watch`) hot-swap a model of either kind.

Without a place the server runs on `CUDAPlace(0)`, which raises when no
card is visible; pass `CPUPlace()` to serve on the host.
`ServeConfig(pulse_port=0)` starts the process's health plane
(``observe/pulse``; the `observe` flag must be on) with this server's
queue and warm-version check on `/readyz`. `add_model(sparse=)` wires
the serve-time distributed sparse read path (``fleet/sparse.py``);
`submit_prefill` / `submit_prefilled` are the two halves of a
disaggregated generation (``torrent/``).
"""

from __future__ import annotations

import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as _FuturesTimeout
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from ..core.executor import Executor, Place
from ..observe import metrics as _metrics
from .batcher import MicroBatcher
from .bucketing import BucketLadder
from .decode import DecodeEngine, GenerationResult, GenerationStream
from .errors import (BadRequestError, DeadlineExceededError,
                     ModelNotFoundError, ServeError)
from .registry import ModelRegistry


@dataclass
class ServeConfig:
    """Per-server defaults (overridable per model in add_model)."""

    batch_timeout_ms: float = 2.0     # max wait of a lone request
    max_queue: int = 256              # admission-control bound, requests
    default_deadline_ms: Optional[float] = None
    watch_interval_s: float = 2.0
    # slot-admission policy: "continuous" (finished sequences vacate
    # mid-batch, default) or "drain" (classic drain-and-refill)
    decode_admission: str = "continuous"
    # rehearsal knobs: model the compute-bound prefill / memory-bound
    # decode cost split as engine-thread sleeps — 0.0 disables (see
    # DecodeEngine); 0 in any real deployment
    simulate_prefill_us_per_token: float = 0.0
    simulate_decode_step_us: float = 0.0
    # expose this process's health plane and this server's
    # queue-saturation readiness check on it (0 = ephemeral port;
    # requires the observe flag — start_pulse refuses otherwise)
    pulse_port: Optional[int] = None


class InferenceServer:
    def __init__(self, place: Optional[Place] = None,
                 config: Optional[ServeConfig] = None):
        self.config = config or ServeConfig()
        self._exe = Executor(place)
        self.registry = ModelRegistry(executor=self._exe)
        self._batchers: Dict[str, MicroBatcher] = {}
        self._engines: Dict[str, DecodeEngine] = {}
        self._closed = False
        self.pulse_port: Optional[int] = None
        self._pulse_check_name: Optional[str] = None
        if self.config.pulse_port is not None:
            from ..observe import health as _health
            from ..observe import pulse as _pulse
            self.pulse_port = _pulse.start_pulse(self.config.pulse_port)
            # instance-scoped name: two servers in one process (tests, a
            # blue/green pair) must not clobber each other's check, and
            # close() of one must not unregister the survivor's
            self._pulse_check_name = f"serve_queues@{id(self):x}"
            _health.get_engine().register_check(
                self._pulse_check_name, self._pulse_queue_check,
                ready=True)

    def model_detail(self) -> dict:
        """Per-model readiness detail: the active `version` (and its
        content-addressed `version_key`), `warmed` (every ladder rung
        ran), queue depth / capacity / saturation, and whether the model
        is generative."""
        detail = {}
        for name, b in list(self._batchers.items()):
            depth, cap = b.queue_depth(), max(b._max_queue, 1)
            detail[name] = {"depth": depth, "capacity": cap,
                            "saturation": round(depth / cap, 3),
                            "generative": False, "version": None,
                            "version_key": None, "warmed": False}
        for name in list(self._engines):
            detail[name] = {"depth": None, "capacity": None,
                            "saturation": 0.0, "generative": True,
                            "version": None, "version_key": None,
                            "warmed": False}
        for name, d in detail.items():
            try:
                ver = self.registry.get(name)
            except ServeError:
                continue   # mid-load/teardown: version stays None
            d["version"] = ver.version_id
            d["version_key"] = ver.version_key
            d["warmed"] = bool(ver.warmed)
        return detail

    def _pulse_queue_check(self):
        """The pulse /readyz check: per-model queue saturation AND
        per-model version/warm detail. Unready when any queue saturates
        — at the detector's threshold
        (health.SERVE_QUEUE_SATURATION_FRAC), so the two verdicts in one
        /healthz body cannot diverge — or when any model's active
        version is not warmed."""
        from ..observe.health import SERVE_QUEUE_SATURATION_FRAC
        detail = self.model_detail()
        ok = True
        for d in detail.values():
            if d["saturation"] >= SERVE_QUEUE_SATURATION_FRAC:
                ok = False
            if d["version"] is not None and not d["warmed"]:
                ok = False
        return ok, detail

    # -- model management ------------------------------------------------

    def add_model(self, name: str, dirname: str,
                  ladder: Optional[BucketLadder] = None,
                  batch_timeout_ms: Optional[float] = None,
                  max_queue: Optional[int] = None, warm: bool = True,
                  sparse=None):
        """Load, verify, warm and publish a model, then start its
        executor thread. Calling again with the same name hot-swaps (and
        applies any explicitly passed batcher settings to the live
        batcher). A generative dir (decode signature in its MANIFEST)
        gets a DecodeEngine — generate/submit_stream — instead of a
        one-shot MicroBatcher. `sparse` (fleet.SparseServeConfig) wires
        the serve-time distributed embedding read path for dirs whose
        manifest declares pserver-resident lookup tables."""
        ver = self.registry.load(name, dirname, ladder=ladder, warm=warm,
                                 sparse=sparse)
        # a re-register may change the model's KIND (one-shot <->
        # generative): the stale request path must go, or infer() would
        # keep routing one-shot feeds at a prefill program (and
        # generate() would never find its engine)
        if ver.generative and name in self._batchers:
            self._batchers.pop(name).close()
        if not ver.generative and name in self._engines:
            self._engines.pop(name).close()
        if ver.generative:
            if name not in self._engines:
                self._engines[name] = DecodeEngine(
                    self.registry, name,
                    max_queue=(max_queue if max_queue is not None
                               else self.config.max_queue),
                    admission=self.config.decode_admission,
                    simulate_prefill_us_per_token=(
                        self.config.simulate_prefill_us_per_token),
                    simulate_decode_step_us=(
                        self.config.simulate_decode_step_us))
            return ver
        if name not in self._batchers:
            self._batchers[name] = MicroBatcher(
                self.registry, name,
                batch_timeout_ms=(batch_timeout_ms
                                  if batch_timeout_ms is not None
                                  else self.config.batch_timeout_ms),
                max_queue=(max_queue if max_queue is not None
                           else self.config.max_queue))
        else:
            self._batchers[name].reconfigure(
                batch_timeout_ms=batch_timeout_ms, max_queue=max_queue)
        return self.registry.get(name)

    def reload(self, name: str, force: bool = False) -> bool:
        """Explicit hot-swap check (the watcher calls the same path)."""
        return self.registry.reload(name, force=force)

    # -- two-phase swap: stage, then flip ----------------------------------

    def prepare_swap(self, name: str, dirname: Optional[str] = None):
        """Stage (verify + load + warm) a new version without publishing
        it; returns the staged ModelVersion. commit_swap is then a pure
        pointer flip."""
        return self.registry.prepare(name, dirname)

    def commit_swap(self, name: str):
        """Publish the staged version (atomic pointer flip; the old
        version drains via refcount retirement)."""
        return self.registry.commit(name)

    def abort_swap(self, name: str) -> bool:
        """Discard the staged version; the published one keeps serving."""
        return self.registry.abort(name)

    def start_watch(self, interval_s: Optional[float] = None):
        self.registry.start_watch(interval_s if interval_s is not None
                                  else self.config.watch_interval_s)

    # -- one-shot request path ---------------------------------------------

    def submit(self, name: str, feed: Dict[str, np.ndarray],
               deadline_ms: Optional[float] = None) -> Future:
        batcher = self._batchers.get(name)
        if batcher is None:
            if name in self._engines:
                raise BadRequestError(
                    f"model {name!r} is a generative model — use "
                    f"generate/submit_generate/submit_stream, not "
                    f"infer/submit")
            raise ModelNotFoundError(
                f"no model registered as {name!r} "
                f"(registered: {sorted(self._batchers)})")
        if deadline_ms is None:
            deadline_ms = self.config.default_deadline_ms
        return batcher.submit(feed, deadline_ms=deadline_ms)

    def infer(self, name: str, feed: Dict[str, np.ndarray],
              deadline_ms: Optional[float] = None) -> List[np.ndarray]:
        """Synchronous request: returns the fetch list (row-sliced back
        to this request's rows)."""
        if deadline_ms is None:
            deadline_ms = self.config.default_deadline_ms
        fut = self.submit(name, feed, deadline_ms=deadline_ms)
        if deadline_ms is None:
            return fut.result()
        # the batcher enforces the QUEUED deadline; the slack covers a
        # batch already on the card when the deadline strikes
        # _FuturesTimeout: on Python < 3.11 concurrent.futures raises its
        # OWN TimeoutError class, not the builtin
        try:
            return fut.result(timeout=deadline_ms / 1e3 + 30.0)
        except (TimeoutError, _FuturesTimeout):
            raise DeadlineExceededError(
                f"model {name!r}: no result within deadline "
                f"{deadline_ms} ms (+30 s execution slack)") from None

    # -- generative request path -------------------------------------------

    def _engine(self, name: str) -> DecodeEngine:
        eng = self._engines.get(name)
        if eng is None:
            if name in self._batchers:
                raise BadRequestError(
                    f"model {name!r} is a one-shot inference model — use "
                    f"infer/submit, not generate")
            raise ModelNotFoundError(
                f"no generative model registered as {name!r} "
                f"(registered: {sorted(self._engines)})")
        return eng

    def generate(self, name: str, prompt, max_new_tokens: int = 16,
                 deadline_ms: Optional[float] = None) -> GenerationResult:
        """Blocking autoregressive generation (greedy). Retriable
        backpressure raises QueueFullError / CacheExhaustedError
        immediately."""
        if deadline_ms is None:
            deadline_ms = self.config.default_deadline_ms
        return self._engine(name).generate(
            prompt, max_new_tokens=max_new_tokens, deadline_ms=deadline_ms)

    def submit_generate(self, name: str, prompt, max_new_tokens: int = 16,
                        deadline_ms: Optional[float] = None) -> Future:
        """Non-blocking generation: the Future of its GenerationResult."""
        if deadline_ms is None:
            deadline_ms = self.config.default_deadline_ms
        return self._engine(name).submit(
            prompt, max_new_tokens=max_new_tokens, deadline_ms=deadline_ms)

    def submit_stream(self, name: str, prompt, max_new_tokens: int = 16,
                      deadline_ms: Optional[float] = None
                      ) -> GenerationStream:
        """Streaming generation: iterate the returned stream for tokens
        as they decode; stream.future resolves to the GenerationResult."""
        if deadline_ms is None:
            deadline_ms = self.config.default_deadline_ms
        return self._engine(name).submit(
            prompt, max_new_tokens=max_new_tokens, deadline_ms=deadline_ms,
            stream=True)

    # -- disaggregated halves ----------------------------------------------

    def submit_prefill(self, name: str, prompt,
                       deadline_ms: Optional[float] = None) -> Future:
        """Prefill half: run the prompt's prefill step only. The Future
        resolves to a GenerationResult whose `kv` carries the extracted
        KV payload (host numpy) and whose single token seeds the decode
        half."""
        if deadline_ms is None:
            deadline_ms = self.config.default_deadline_ms
        return self._engine(name).submit(
            prompt, deadline_ms=deadline_ms, prefill_only=True)

    def submit_prefilled(self, name: str, prompt, first_token: int,
                         kv: dict, max_new_tokens: int = 16,
                         deadline_ms: Optional[float] = None) -> Future:
        """Decode half: inject a KV payload prefilled elsewhere and run
        the rest of the generation here. Returns the Future of the full
        GenerationResult (its tokens start with `first_token`)."""
        if deadline_ms is None:
            deadline_ms = self.config.default_deadline_ms
        return self._engine(name).submit_prefilled(
            prompt, first_token, kv, max_new_tokens=max_new_tokens,
            deadline_ms=deadline_ms)

    # -- introspection ---------------------------------------------------

    def stats(self) -> dict:
        """Serving-metric snapshot (the metrics registry holds the same
        numbers in exportable form)."""
        out: dict = {"models": {}, "ts": time.time()}
        for name, b in self._batchers.items():
            ver = None
            try:
                ver = self.registry.get(name)
            except ServeError:
                pass
            occ = _metrics.histogram("serve_batch_occupancy").summary(
                model=name)
            lat = _metrics.histogram("serve_request_latency_us").summary(
                model=name)
            waste = _metrics.histogram("serve_padding_waste_ratio").summary(
                model=name)
            out["models"][name] = {
                "version": ver.version_id if ver else None,
                "loaded_at": ver.loaded_at if ver else None,
                "queue_depth": b.queue_depth(),
                "batches": occ["count"] if occ else 0,
                "avg_occupancy": round(occ["mean"], 3) if occ else 0.0,
                "avg_latency_us": round(lat["mean"], 1) if lat else 0.0,
                "avg_padding_waste": round(waste["mean"], 4)
                    if waste else 0.0,
                "requests": {
                    outcome: _metrics.counter("serve_requests_total").value(
                        model=name, outcome=outcome)
                    for outcome in ("ok", "error", "deadline", "queue_full")
                },
            }
        for name, eng in self._engines.items():
            ver = None
            try:
                ver = self.registry.get(name)
            except ServeError:
                pass
            entry = {"version": ver.version_id if ver else None,
                     "generative": True}
            entry.update(eng.stats())
            out["models"][name] = entry
        return out

    def close(self):
        if self._closed:
            return
        self._closed = True
        if self._pulse_check_name is not None:
            from ..observe import health as _health
            _health.get_engine().unregister_check(self._pulse_check_name)
            self._pulse_check_name = None
            self.pulse_port = None
        for b in self._batchers.values():
            b.close()
        self._batchers.clear()
        for e in self._engines.values():
            e.close()
        self._engines.clear()
        self.registry.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

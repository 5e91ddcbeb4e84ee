"""InferenceServer: the in-process generative serving facade.

Mirror of ``paddle_tpu/serve/server.py`` (generative half):

    srv = serve.InferenceServer()                 # CUDAPlace(0)
    srv.add_model("lm", "/models/lm")             # load, verify, warm
    res = srv.generate("lm", prompt, max_new_tokens=32)
    fut = srv.submit_generate("lm", prompt)        # Future
    for tok in srv.submit_stream("lm", prompt): ...

Without a place the server runs on `CUDAPlace(0)`, which raises when no
card is visible; pass `CPUPlace()` to serve on the host.
"""

from __future__ import annotations

import time
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Dict, Optional

from ..core.executor import Executor, Place
from .decode import DecodeEngine, GenerationResult, GenerationStream
from .errors import ModelNotFoundError
from .registry import ModelRegistry


@dataclass
class ServeConfig:
    """Per-server defaults (overridable per model in add_model)."""

    max_queue: int = 256              # admission-control bound, requests
    default_deadline_ms: Optional[float] = None
    # slot-admission policy: "continuous" (finished sequences vacate
    # mid-batch, default) or "drain" (classic drain-and-refill)
    decode_admission: str = "continuous"


class InferenceServer:
    def __init__(self, place: Optional[Place] = None,
                 config: Optional[ServeConfig] = None):
        self.config = config or ServeConfig()
        self._exe = Executor(place)
        self.registry = ModelRegistry(self._exe)
        self._engines: Dict[str, DecodeEngine] = {}
        self._closed = False

    def add_model(self, name: str, dirname: str,
                  max_queue: Optional[int] = None, warm: bool = True):
        """Load, verify, warm and publish a generative model dir, then
        start its engine thread."""
        ver = self.registry.load(name, dirname, warm=warm)
        self._engines[name] = DecodeEngine(
            self.registry, name,
            max_queue=(max_queue if max_queue is not None
                       else self.config.max_queue),
            admission=self.config.decode_admission)
        return ver

    def _engine(self, name: str) -> DecodeEngine:
        eng = self._engines.get(name)
        if eng is None:
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

    def stats(self) -> dict:
        """Serving-metric snapshot (the metrics registry holds the same
        numbers in exportable form)."""
        out: dict = {"models": {}, "ts": time.time()}
        for name, eng in self._engines.items():
            entry = {"version": self.registry.get(name).version_id,
                     "generative": True}
            entry.update(eng.stats())
            out["models"][name] = entry
        return out

    def close(self):
        if self._closed:
            return
        self._closed = True
        for e in self._engines.values():
            e.close()
        self._engines.clear()
        self.registry.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

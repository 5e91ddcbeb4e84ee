"""Python side of the C inference ABI (paddle_tpu_torch/capi/).

The C++ shim (capi.cc) embeds CPython and calls `create` / `Predictor.run`
here; this module owns the model, the scope and the prepared step, the
same `load_inference_model` + `Executor` path the Python API runs, so the
C ABI and the Python API share one predictor implementation (reference
analog: api_impl.cc NativePaddlePredictor::Run driving the same Executor
as python).

The C signature has no place argument. The predictor runs on
`CUDAPlace(0)`; the environment variable ``PADDLE_TPU_TORCH_CAPI_PLACE``
asks for the host (``cpu``) or names the card (``cuda``, the default).
With no card and the variable unset, `create` raises (and
`PD_CreatePredictor` returns NULL with the error in `PD_LastError`): it
never falls back to the host.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

PLACE_ENV = "PADDLE_TPU_TORCH_CAPI_PLACE"


def _place():
    from .core.executor import CPUPlace, CUDAPlace
    want = os.environ.get(PLACE_ENV, "") or "cuda"
    if want == "cpu":
        return CPUPlace()
    if want == "cuda":
        return CUDAPlace(0)
    raise ValueError(f"{PLACE_ENV}={want!r}: expected 'cpu' or 'cuda'")


class Predictor:
    def __init__(self, model_dir: str):
        from . import io
        from .core.executor import Executor, Scope
        self.scope = Scope()
        self.exe = Executor(_place())
        self.program, self.feed_names, self.fetch_targets = \
            io.load_inference_model(model_dir, self.exe, scope=self.scope)
        self._prepared = self.exe.prepare(
            self.program, fetch_list=self.fetch_targets, scope=self.scope)

    def run(self, feed_list: List[Tuple[str, tuple, str, bytes]]):
        """feed_list entries: (name, shape, dtype_str, raw_bytes); empty
        name means positional (feed_names order). Returns a list of
        (fetch_name, dtype_str, contiguous ndarray)."""
        from .core.executor import host_array
        feeds = {}
        for i, (name, shape, dtype, raw) in enumerate(feed_list):
            arr = np.frombuffer(raw, dtype=dtype).reshape(shape)
            feeds[name or self.feed_names[i]] = arr
        outs = self._prepared.run(feeds, return_numpy=False)
        results = []
        for tgt, v in zip(self.fetch_targets, outs):
            a = np.ascontiguousarray(host_array(v))
            if a.dtype == np.float64:
                a = a.astype(np.float32)
            name = tgt.name if hasattr(tgt, "name") else str(tgt)
            results.append((name, str(a.dtype), a))
        return results


def create(model_dir: str) -> Predictor:
    return Predictor(model_dir)

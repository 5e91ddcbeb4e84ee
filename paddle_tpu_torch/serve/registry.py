"""Model registry: generative model dirs -> warmed prepared programs.

Mirror of the load path of ``paddle_tpu/serve/registry.py``
(`load` / `_load_version` / `_load_decode` / `_warm_decode`). A served
model is a generative `save_inference_model` dir (``models/tiny_lm.py``
writes one): its MANIFEST.json carries the decode-step signature. The
registry turns the dir into a `ModelVersion`:

1. the dir is sha256-verified against its MANIFEST.json and its params
   are loaded into a fresh scope on the executor's device;
2. the KV cache vars, which are never saved, are materialized as zeros on
   the device at the shape and type the signature declares (float32, or
   int8 with its per-block scale vars and the requant counter);
3. the prefill program is run once at every ladder rung and the decode
   program once, so the kernels are built and launched before traffic.

Hot swap, dir watching, the one-shot path and sparse serving are not
ported yet: loading a name twice raises.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List

import numpy as np
import torch

from .. import io as _io
from ..core.executor import Executor, Scope
from ..observe import metrics as _metrics
from .bucketing import BucketLadder, feed_spec, warm_feed_shapes
from .errors import (BadRequestError, ModelNotFoundError,
                     ModelUnavailableError)
from .kvcache import PagedKVCache


def _fingerprint(dirname: str):
    """Identity of the committed model dir (save_inference_model replaces
    the whole dir by rename, so a new save has a new inode)."""
    st = os.stat(dirname)
    return (st.st_ino, st.st_mtime_ns)


class DecodeModel:
    """The decode-step program of a generative ModelVersion, prepared
    against the SAME scope as the prefill program (they share parameters
    and the ``*@KV_CACHE`` cache vars), plus the host block allocator."""

    def __init__(self, program, prepared, feed_names, fetch_names,
                 signature: dict, kvcache: PagedKVCache):
        self.program = program
        self.prepared = prepared
        self.feed_names = list(feed_names)
        self.fetch_names = list(fetch_names)
        self.signature = dict(signature)
        self.kvcache = kvcache


def read_model_manifest(dirname: str) -> dict:
    """The model dir's MANIFEST.json as a dict ({} when there is none or
    it is unreadable — the verified load names the problem)."""
    path = os.path.join(dirname, _io.MODEL_MANIFEST)
    if not os.path.isfile(path):
        return {}
    try:
        with open(path) as f:
            return json.load(f) or {}
    except (OSError, json.JSONDecodeError):
        return {}


def ladder_from_signature(sig: dict) -> BucketLadder:
    """The prefill bucket ladder a decode signature implies: prompt rows
    x prompt-length rungs."""
    return BucketLadder(rows=tuple(sig["prefill_rows"]),
                        dims={"tokens": {1: tuple(sig["prefill_seq_rungs"])}})


class ModelVersion:
    """One loaded and warmed version of a served model."""

    def __init__(self, name: str, dirname: str, fingerprint, program,
                 feed_names: List[str], fetch_names: List[str],
                 scope: Scope, prepared, ladder: BucketLadder, spec,
                 decode: DecodeModel):
        self.name = name
        self.dirname = dirname
        self.fingerprint = fingerprint
        self.program = program
        self.feed_names = feed_names
        self.fetch_names = fetch_names
        self.scope = scope
        self.prepared = prepared
        self.ladder = ladder
        self.spec = spec
        self.decode = decode
        self.warmed = False

    @property
    def version_id(self) -> str:
        return f"{self.fingerprint[0]}:{self.fingerprint[1]}"


class ModelRegistry:
    def __init__(self, executor: Executor):
        self._exe = executor
        self._lock = threading.Lock()
        self._versions: Dict[str, ModelVersion] = {}

    def load(self, name: str, dirname: str, warm: bool = True
             ) -> ModelVersion:
        """Load, verify, warm and publish `name` from `dirname`."""
        with self._lock:
            if name in self._versions:
                raise BadRequestError(
                    f"model {name!r} is already loaded (hot swap is not "
                    f"ported yet)")
        ver = self._load_version(name, os.path.abspath(dirname), warm)
        with self._lock:
            self._versions[name] = ver
        return ver

    def _load_version(self, name, dirname, warm) -> ModelVersion:
        t0 = time.perf_counter()
        manifest = read_model_manifest(dirname)
        sig = manifest.get("decode")
        if sig is None:
            raise BadRequestError(
                f"model dir {dirname} has no decode signature in its "
                f"manifest: only generative models are served by this "
                f"package yet")
        fp = _fingerprint(dirname)
        scope = Scope()
        program, feed_names, fetch_vars = _io.load_inference_model(
            dirname, self._exe, scope=scope, verify=True)
        spec = feed_spec(program, feed_names)
        # the KV cache is never saved: zeros of the declared shape, made
        # on the device. The int8 residency adds its per-block scale vars
        # and the shared requant counter, all named by the signature
        shape = (sig["num_blocks"], sig["block_size"], sig["num_heads"],
                 sig["head_dim"])
        device = self._exe.place.torch_device()
        cache_dtype = torch.int8 if sig.get("kv_dtype") == "int8" \
            else torch.float32
        for cname in sig["cache_vars"]:
            scope.set_var(cname, torch.zeros(shape, dtype=cache_dtype,
                                             device=device))
        for sname in (sig.get("scale_vars") or {}).values():
            scope.set_var(sname, torch.zeros((sig["num_blocks"],),
                                             dtype=torch.float32,
                                             device=device))
        if sig.get("requant_var"):
            scope.set_var(sig["requant_var"],
                          torch.zeros((1,), dtype=torch.int32, device=device))
        prepared = self._exe.prepare(program, fetch_list=fetch_vars,
                                     scope=scope)
        decode = self._load_decode(name, dirname, scope, sig,
                                   f"{fp[0]}:{fp[1]}")
        ver = ModelVersion(name, dirname, fp, program, list(feed_names),
                           [v.name for v in fetch_vars], scope, prepared,
                           ladder_from_signature(sig), spec, decode)
        if warm:
            self._warm(ver)
            self._warm_decode(ver)
            ver.warmed = True
        _metrics.counter("serve_model_loads_total",
                         "model versions loaded (incl. warmup)").inc(
                             model=name)
        _metrics.histogram(
            "serve_model_load_seconds",
            "load+verify+warm wall time per version").observe(
                time.perf_counter() - t0, model=name)
        return ver

    def _load_decode(self, name, dirname, scope, sig, version_id
                     ) -> DecodeModel:
        loaded = _io.load_decode_program(dirname)
        if loaded is None:
            raise ModelUnavailableError(
                f"model dir {dirname} declares a decode signature in its "
                f"manifest but has no {_io.DECODE_FILENAME} program")
        dprog, dfeeds, dfetches = loaded
        fetch_vars = [dprog.global_block().var(n) for n in dfetches]
        prepared = self._exe.prepare(dprog, fetch_list=fetch_vars,
                                     scope=scope)
        kv = PagedKVCache(sig["num_blocks"], sig["block_size"],
                          sig["max_blocks_per_seq"], sig["max_slots"],
                          model=name, version=version_id)
        return DecodeModel(dprog, prepared, dfeeds, dfetches, sig, kv)

    @staticmethod
    def _warm_decode(ver: ModelVersion):
        """Run the decode step once on zero feeds (every slot inactive):
        the step has exactly one feed shape, so this covers every later
        step."""
        dec = ver.decode
        S = dec.signature["max_slots"]
        dec.prepared.run({
            "tokens": np.zeros((S, 1), np.int64),
            "block_tables": np.zeros(
                (S, dec.signature["max_blocks_per_seq"]), np.int32),
            "seq_lens": np.zeros((S,), np.int32),
        })

    @staticmethod
    def _warm(ver: ModelVersion):
        """Run the prefill program once at every ladder rung (zero feeds:
        every position lands in the trash block)."""
        for feeds in warm_feed_shapes(ver.spec, ver.ladder):
            ver.prepared.run(feeds)

    def get(self, name: str) -> ModelVersion:
        with self._lock:
            ver = self._versions.get(name)
        if ver is None:
            raise ModelNotFoundError(
                f"no model registered as {name!r} "
                f"(registered: {self.names()})")
        return ver

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._versions)

    def close(self):
        with self._lock:
            for ver in self._versions.values():
                ver.decode.kvcache.close()
            self._versions.clear()

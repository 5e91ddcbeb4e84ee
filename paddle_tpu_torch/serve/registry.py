"""Hot-swappable model registry: model dirs -> warmed prepared programs.

Mirror of ``paddle_tpu/serve/registry.py``. A served model is a
`save_inference_model` dir. The registry turns one into a `ModelVersion`
— its own Scope holding the params on the executor's device, a
`PreparedProgram` handle, and every ladder rung run once ahead of
traffic — and publishes it behind an atomic pointer. A dir whose
MANIFEST.json carries a decode signature (``models/tiny_lm.py`` writes
one) is generative: the version also holds the decode-step program, its
KV cache vars (never saved: zeros on the device at the shape and type
the signature declares) and the host block allocator.

Hot swap protocol (`save_inference_model` stages the whole dir and
swaps it in with renames, so a watcher can never observe a half-written
model):

1. a new version is detected (dir inode/mtime fingerprint changed, or an
   explicit `reload`), or staged by `prepare`;
2. the new dir is sha256-verified against its MANIFEST.json and loaded
   into a FRESH scope (`io.load_inference_model(verify=True)`);
3. every rung of the ladder is run once (and a generative version's
   decode step once) — the new version serves its first request with
   every kernel built;
4. the published pointer flips under the registry lock — requests that
   acquired the old version finish on it, new acquisitions get the new
   one; a request never sees a half-loaded model;
5. the old version retires once its in-flight refcount drains to zero
   (`ModelVersion.wait_retired` lets tests and drain logic observe it).

Failures in 2-3 leave the old version serving untouched — a corrupt new
dir costs an error log, not an outage. While a swap warms, two versions
are resident on the device at once.

Not ported: the serve-time distributed sparse read path (a manifest with
a `sparse` key needs ``fleet/``) and the JAX package's warm-shape
bookkeeping for its compile cache (``observe/steplog``).
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import io as _io
from ..core.executor import Executor, Place, Scope
from ..observe import metrics as _metrics
from .bucketing import BucketLadder, feed_spec, warm_feed_shapes
from .errors import ModelNotFoundError, ModelUnavailableError
from .kvcache import PagedKVCache

logger = logging.getLogger(__name__)


def _fingerprint(dirname: str):
    """Identity of the CURRENT committed model dir. save_inference_model
    replaces the whole dir by rename, so a new save = new inode (and new
    mtime); stat of the dir itself is race-free against the swap."""
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


def read_decode_signature(dirname: str) -> Optional[dict]:
    """The MANIFEST's `decode` key, or None for a one-shot model dir."""
    return read_model_manifest(dirname).get("decode")


def ladder_from_signature(sig: dict) -> BucketLadder:
    """The prefill bucket ladder a decode signature implies: prompt rows
    x prompt-length rungs."""
    return BucketLadder(rows=tuple(sig["prefill_rows"]),
                        dims={"tokens": {1: tuple(sig["prefill_seq_rungs"])}})


class ModelVersion:
    """One loaded and warmed immutable version of a served model."""

    def __init__(self, name: str, dirname: str, fingerprint, program,
                 feed_names: List[str], fetch_names: List[str],
                 scope: Scope, prepared, ladder: BucketLadder, spec):
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
        self.loaded_at = time.time()
        self.decode: Optional[DecodeModel] = None
        # content-addressed identity: sha256 of the dir's MANIFEST.json
        # (which names every payload file's sha), equal for two loads of
        # the same push wherever they run; None for a manifest-less dir
        self.manifest_sha: Optional[str] = None
        # False until every ladder rung (and the decode step) ran once
        self.warmed = False
        self._refs = 0
        self._retired = False
        self._fully_retired = threading.Event()

    @property
    def generative(self) -> bool:
        return self.decode is not None

    @property
    def version_id(self) -> str:
        return f"{self.fingerprint[0]}:{self.fingerprint[1]}"

    @property
    def version_key(self) -> str:
        """The cross-process identity: the manifest sha when the dir has
        one, else the local fingerprint."""
        return self.manifest_sha or self.version_id

    def retired(self) -> bool:
        return self._fully_retired.is_set()

    def wait_retired(self, timeout: Optional[float] = None) -> bool:
        """Block until this version is both unpublished and drained of
        in-flight requests."""
        return self._fully_retired.wait(timeout)


class _Slot:
    """Published pointer + load config for one model name."""

    def __init__(self, dirname: str, ladder: BucketLadder):
        self.dirname = dirname
        self.ladder = ladder
        self.current: Optional[ModelVersion] = None
        # a fully loaded, verified and warmed version staged by prepare()
        # and published only by commit()
        self.staged: Optional[ModelVersion] = None


class ModelRegistry:
    """Without an executor or a place the registry runs on
    `CUDAPlace(0)`, which raises when no card is visible."""

    def __init__(self, place: Optional[Place] = None,
                 executor: Optional[Executor] = None):
        self._exe = executor or Executor(place)
        self._lock = threading.Lock()
        self._slots: Dict[str, _Slot] = {}
        self._watcher: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- loading / swapping ----------------------------------------------

    def _slot_for_load(self, name, dirname, ladder):
        """Resolve (and update) the slot + the manifest-driven load plan."""
        dirname = os.path.abspath(dirname)
        # ONE manifest read per load: the ladder below and the cache
        # sizing in _load_version must come from the same signature (two
        # reads would race a concurrent atomic dir swap into a version
        # whose ladder disagrees with its warmed rungs)
        manifest = read_model_manifest(dirname)
        sig = manifest.get("decode")
        if ladder is None and sig is not None:
            ladder = ladder_from_signature(sig)
        with self._lock:
            slot = self._slots.get(name)
            if slot is None:
                slot = self._slots[name] = _Slot(
                    dirname, ladder or BucketLadder())
            else:
                slot.dirname = dirname
                if ladder is not None:
                    slot.ladder = ladder
        return slot, dirname, manifest

    def load(self, name: str, dirname: str,
             ladder: Optional[BucketLadder] = None,
             warm: bool = True) -> ModelVersion:
        """Load (first call) or hot-swap (subsequent calls) `name` from
        `dirname`. Blocks until the new version is verified, loaded and
        warmed; only then does the published pointer flip."""
        slot, dirname, manifest = self._slot_for_load(name, dirname, ladder)
        ver = self._load_version(name, dirname, slot.ladder, warm, manifest)
        self._publish(name, slot, ver)
        return ver

    def _publish(self, name: str, slot: _Slot, ver: ModelVersion):
        with self._lock:
            old, slot.current = slot.current, ver
            if old is not None:
                old._retired = True
                if old._refs == 0:
                    self._fully_retire_locked(old)
        if old is not None:
            _metrics.counter(
                "serve_hot_swaps_total",
                "model versions atomically swapped in").inc(model=name)
            logger.info("serve: hot-swapped model %r -> version %s "
                        "(old drains %d in-flight)", name, ver.version_id,
                        old._refs)

    # -- two-phase swap: stage now, flip later ----------------------------

    def prepare(self, name: str, dirname: Optional[str] = None,
                warm: bool = True) -> ModelVersion:
        """Stage a new version of `name` WITHOUT publishing it: verify,
        load and warm exactly like load(), but park the result so a later
        commit() is a pure pointer flip. Re-staging replaces (and
        releases) a previously staged version.

        The slot's published config (dirname, ladder) is NOT touched
        until commit(): a dir watcher ticking between prepare and commit
        keeps fingerprinting the PUBLISHED dir. `name` must already be
        loaded. A generative dir's NEW decode signature re-derives the
        prefill ladder; one-shot dirs keep the slot's configured ladder."""
        slot = self._slot(name)
        dirname = os.path.abspath(dirname) if dirname is not None \
            else slot.dirname
        manifest = read_model_manifest(dirname)
        sig = manifest.get("decode")
        ladder = ladder_from_signature(sig) if sig is not None \
            else slot.ladder
        ver = self._load_version(name, dirname, ladder, warm, manifest)
        with self._lock:
            prev, slot.staged = slot.staged, ver
        if prev is not None:
            self._discard_staged(prev)
        return ver

    def commit(self, name: str) -> ModelVersion:
        """Publish the staged version (prepare() must have run): the
        atomic pointer flip. Only now does the slot adopt the staged
        version's dir and ladder as its published config."""
        slot = self._slot(name)
        with self._lock:
            ver, slot.staged = slot.staged, None
            if ver is not None:
                slot.dirname = ver.dirname
                slot.ladder = ver.ladder
        if ver is None:
            raise ModelUnavailableError(
                f"model {name!r}: no staged version to commit — call "
                f"prepare() first")
        self._publish(name, slot, ver)
        return ver

    def abort(self, name: str) -> bool:
        """Discard the staged version; the published one keeps serving."""
        slot = self._slot(name)
        with self._lock:
            ver, slot.staged = slot.staged, None
        if ver is None:
            return False
        self._discard_staged(ver)
        return True

    @staticmethod
    def _discard_staged(ver: ModelVersion):
        ver._retired = True
        ver._fully_retired.set()
        if ver.decode is not None:
            ver.decode.kvcache.close()

    def staged(self, name: str) -> Optional[ModelVersion]:
        with self._lock:
            slot = self._slots.get(name)
            return slot.staged if slot is not None else None

    def _load_version(self, name, dirname, ladder, warm,
                      manifest=None) -> ModelVersion:
        t0 = time.perf_counter()
        manifest = manifest if manifest is not None \
            else read_model_manifest(dirname)
        sig = manifest.get("decode")
        if manifest.get("sparse") is not None:
            raise ModelUnavailableError(
                f"model dir {dirname} holds its lookup tables "
                f"{sorted(manifest['sparse'].get('tables', {}))} in "
                f"pserver shards (manifest `sparse` key): the serve-time "
                f"sparse read path (fleet/) is not ported")
        fp = _fingerprint(dirname)
        scope = Scope()
        # verify=True: sha256 the whole dir against its MANIFEST before
        # deserializing — a bit-rotted dir raises ModelIntegrityError
        # here and the previously published version keeps serving
        program, feed_names, fetch_vars = _io.load_inference_model(
            dirname, self._exe, scope=scope, verify=True)
        spec = feed_spec(program, feed_names)
        if sig is not None:
            self._materialize_cache(scope, sig)
        prepared = self._exe.prepare(program, fetch_list=fetch_vars,
                                     scope=scope)
        ver = ModelVersion(name, dirname, fp, program, list(feed_names),
                           [v.name for v in fetch_vars], scope, prepared,
                           ladder, spec)
        manifest_path = os.path.join(dirname, _io.MODEL_MANIFEST)
        if os.path.isfile(manifest_path):
            ver.manifest_sha = _io.file_sha256(manifest_path)
        if sig is not None:
            ver.decode = self._load_decode(ver, sig)
        if warm:
            self._warm(ver)
            if ver.decode is not None:
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

    def _materialize_cache(self, scope: Scope, sig: dict):
        """The KV cache is never saved: zeros of the declared shape, made
        on the device. The int8 residency adds its per-block scale vars
        and the shared requant counter, all named by the signature."""
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

    def _load_decode(self, ver: ModelVersion, sig) -> DecodeModel:
        """Prepare the decode-step program against the version's scope
        (shared params + cache vars) and build its block allocator."""
        loaded = _io.load_decode_program(ver.dirname)
        if loaded is None:
            raise ModelUnavailableError(
                f"model dir {ver.dirname} declares a decode signature in "
                f"its manifest but has no {_io.DECODE_FILENAME} program")
        dprog, dfeeds, dfetches = loaded
        fetch_vars = [dprog.global_block().var(n) for n in dfetches]
        prepared = self._exe.prepare(dprog, fetch_list=fetch_vars,
                                     scope=ver.scope)
        kv = PagedKVCache(sig["num_blocks"], sig["block_size"],
                          sig["max_blocks_per_seq"], sig["max_slots"],
                          model=ver.name, version=ver.version_id)
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
        """Run the program once at every ladder rung (zero feeds; a
        prefill's positions all land in the trash block)."""
        for feeds in warm_feed_shapes(ver.spec, ver.ladder):
            ver.prepared.run(feeds)

    def reload(self, name: str, force: bool = False) -> bool:
        """Re-check `name`'s dir; hot-swap if its fingerprint changed (or
        unconditionally with `force`). Returns True when a swap
        happened."""
        slot = self._slot(name)
        fp = _fingerprint(slot.dirname)
        cur = slot.current
        if not force and cur is not None and fp == cur.fingerprint:
            return False
        self.load(name, slot.dirname, ladder=slot.ladder)
        return True

    # -- request-path access ---------------------------------------------

    def _slot(self, name: str) -> _Slot:
        with self._lock:
            slot = self._slots.get(name)
        if slot is None:
            raise ModelNotFoundError(
                f"no model registered as {name!r} "
                f"(registered: {sorted(self._slots)})")
        return slot

    def get(self, name: str) -> ModelVersion:
        """The currently published version (no refcount — use acquire/
        release on the request path)."""
        ver = self._slot(name).current
        if ver is None:
            raise ModelUnavailableError(
                f"model {name!r} has no servable version (load failed or "
                f"in flight)")
        return ver

    def acquire(self, name: str) -> ModelVersion:
        """Pin the current version for one batch: the version cannot
        fully retire until every acquisition is released."""
        with self._lock:
            slot = self._slots.get(name)
            ver = slot.current if slot is not None else None
            if slot is None:
                raise ModelNotFoundError(f"no model registered as {name!r}")
            if ver is None:
                raise ModelUnavailableError(
                    f"model {name!r} has no servable version")
            ver._refs += 1
        return ver

    @staticmethod
    def _fully_retire_locked(ver: ModelVersion):
        """Unpublished AND drained: a retired generative version's KV
        gauges are zeroed too."""
        ver._fully_retired.set()
        if ver.decode is not None:
            ver.decode.kvcache.close()

    def release(self, ver: ModelVersion):
        with self._lock:
            ver._refs -= 1
            if ver._retired and ver._refs == 0:
                self._fully_retire_locked(ver)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._slots)

    # -- dir watching ------------------------------------------------------

    def start_watch(self, interval_s: float = 2.0):
        """Poll every registered model dir; hot-swap on change. Idempotent.
        Polling (not inotify) keeps it dependency-free and works on the
        network filesystems model pushes land on. The watcher thread runs
        the new version's warm-up while the old one serves."""
        if self._watcher is not None and self._watcher.is_alive():
            return
        self._stop.clear()

        def _loop():
            while not self._stop.wait(interval_s):
                for name in self.names():
                    try:
                        if self.reload(name):
                            logger.info("serve: watcher swapped %r", name)
                    except Exception as e:
                        # incl. FileNotFoundError in a swap's rename
                        # window and ModelIntegrityError on a bad push —
                        # the published version keeps serving
                        logger.warning("serve: watcher reload of %r "
                                       "failed: %r", name, e)

        self._watcher = threading.Thread(target=_loop, daemon=True,
                                         name="serve-model-watcher")
        self._watcher.start()

    def stop_watch(self):
        self._stop.set()
        if self._watcher is not None:
            self._watcher.join(timeout=5)
            self._watcher = None

    def close(self):
        self.stop_watch()
        with self._lock:
            for slot in self._slots.values():
                if slot.staged is not None:
                    self._discard_staged(slot.staged)
                    slot.staged = None
                if slot.current is not None:
                    slot.current._retired = True
                    if slot.current._refs == 0:
                        self._fully_retire_locked(slot.current)
                    elif slot.current.decode is not None:
                        # shutting down with refs still held: zero the
                        # gauges anyway — no more traffic is coming
                        slot.current.decode.kvcache.close()
                slot.current = None
            self._slots.clear()

"""fluid-fleet: serve-time distributed embedding lookup.

Mirror of ``paddle_tpu/fleet/sparse.py``, copied.

The DeepFM-class serving problem: the embedding table is the model —
and at recsys scale it does not fit one serving host. Training already
solved this shape with the pserver sparse tables (row-sharded by
``id % n_servers``, prefetch + sparse push); this module is the READ
half of that path relocated to inference time, so a model whose tables
live only in pserver shards serves end to end:

- ``save_sparse_inference_model`` saves an inference dir WITHOUT the
  distributed tables' values (``io.save_inference_model(exclude_vars=)``)
  and records their specs under the manifest's ``sparse`` key;
- ``SparseServeConfig`` is what a replica passes to ``add_model`` — it
  owns one READ-ONLY ``PSClient`` (``read_only=True``: a serving process
  physically cannot push) with the fluid-wire codec negotiated, so
  embedding-row pulls ride a wire ~4x cheaper than raw;
- ``SparseLookupPlan`` (one per ModelVersion) augments each coalesced
  batch: unique the batch's ids, pull missing rows through a bounded
  LRU ``RowCache``, feed a fixed-shape ``[cap, width]`` sub-table under
  the table's own name with ids remapped — the exact feed idiom
  ``AsyncPSTrainer`` uses for training, so the program needs no rewrite
  and the compile signature is constant (zero steady-state recompiles).

Freshness contract: cached rows are as fresh as the last pull; the
cache is keyed to its ModelVersion and dropped when the version retires,
so a hot swap IS the invalidation point — a model push that retrains
embeddings swaps the dir and every replica re-pulls. ``invalidate()``
exists for out-of-band refreshes.

fluid-haven: with the pserver shards running as replicated pairs, pass
``SparseServeConfig(endpoints=[primary], replicas={primary: [backup]})``
— a standby backup serves bounded-stale row reads WITHOUT promotion, so
a primary SIGKILL never takes the serving plane down with it (the read
fails over per-request; after a handover the retired primary's redirect
moves the client to the successor). Pinned by
``tests/test_torch_fleet.py::test_fleet_sparse_row_pulls_survive_primary_kill``.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..observe import metrics as _metrics
from ..serve.errors import BadRequestError

#: MANIFEST.json key carrying the pserver-resident table specs
SPARSE_MANIFEST_KEY = "sparse"

#: default bound on cached rows per plan (per version) — at DeepFM width
#: 16 f32 this is ~4 MB; sized for the hot head of a zipfian id stream
DEFAULT_CACHE_ROWS = 65536


def sparse_table_specs(program) -> Dict[str, dict]:
    """{table name: spec} for every ``is_distributed`` lookup_table op in
    `program` — the serve-side twin of the transpiler's sparse_specs
    scan (distribute_transpiler._build_async_plan step 1)."""
    specs: Dict[str, dict] = {}
    block = program.global_block()
    for op in block.ops:
        if op.type != "lookup_table" or not op.attrs.get("is_distributed"):
            continue
        wname = op.input("W")[0]
        w = block._find_var_recursive(wname)
        spec = specs.setdefault(wname, {
            "rows": int(w.shape[0]), "width": int(w.shape[1]),
            "dtype": str(w.dtype), "ids_names": [],
        })
        ids_name = op.input("Ids")[0]
        if ids_name not in spec["ids_names"]:
            spec["ids_names"].append(ids_name)
    return specs


def save_sparse_inference_model(dirname, feeded_var_names, target_vars,
                                executor, main_program=None, scope=None,
                                cap: int = 256, manifest_extra=None,
                                **save_kwargs):
    """``io.save_inference_model`` for a model with distributed lookup
    tables: the tables' VALUES stay out of the dir (they live in pserver
    shards), and the manifest's ``sparse`` key records what a serving
    replica must prefetch — table specs, the ids feeds each table reads,
    and ``cap`` (the max unique rows one padded batch may touch; the
    fed sub-table's fixed row count).

    Raises BadRequestError when the program has no distributed table —
    use the plain save in that case (a silently-empty sparse key would
    make every replica demand pserver endpoints for nothing)."""
    from .. import io as _io
    from ..core import executor as core_exec

    main_program = main_program or _io.ir.default_main_program()
    pruned = _io.get_inference_program(target_vars, main_program)
    specs = sparse_table_specs(pruned)
    if not specs:
        raise BadRequestError(
            "save_sparse_inference_model: no is_distributed lookup_table "
            "in the pruned inference program — use io.save_inference_model")
    # the ids every table reads must be FED (the plan remaps them on the
    # host); a lookup over a computed ids tensor can't ride this path
    feed_set = set(feeded_var_names)
    for wname, spec in specs.items():
        missing = [n for n in spec["ids_names"] if n not in feed_set]
        if missing:
            raise BadRequestError(
                f"distributed table {wname!r} is looked up with ids "
                f"{missing} that are not model feeds — the serve-time "
                f"remap happens on the host feed boundary")
    # exclude the tables AND their table-SIZED derived state: a trained
    # program's pruned slice still carries persistable optimizer slots
    # (fm_v_moment_0, [rows, width]) — saving those would smuggle the
    # too-big-for-one-host bytes right back into the model dir. The full
    # skip list is RECORDED in the manifest so the loader skips exactly
    # what the saver excluded (no naming-rule drift between the two).
    exclude = set(specs)
    for v in pruned.global_block().vars.values():
        if v.persistable and any(v.name.startswith(w + "_")
                                 for w in specs):
            exclude.add(v.name)
    extra = {SPARSE_MANIFEST_KEY: {"cap": int(cap), "tables": specs,
                                   "skip_vars": sorted(exclude)},
             **(manifest_extra or {})}
    scope = scope or core_exec.global_scope()
    return _io.save_inference_model(
        dirname, feeded_var_names, target_vars, executor,
        main_program=main_program, scope=scope,
        exclude_vars=exclude, manifest_extra=extra, **save_kwargs)


class RowCache:
    """Bounded LRU of (table, id) -> row. Thread-safe; rows are stored
    as copies so a cached row can never alias a caller's buffer."""

    def __init__(self, capacity_rows: int = DEFAULT_CACHE_ROWS):
        self.capacity = int(capacity_rows)
        self._lock = threading.Lock()
        self._rows: OrderedDict = OrderedDict()

    def __len__(self):
        with self._lock:
            return len(self._rows)

    def get(self, table: str, row_id: int) -> Optional[np.ndarray]:
        key = (table, row_id)
        with self._lock:
            row = self._rows.get(key)
            if row is not None:
                self._rows.move_to_end(key)
            return row

    def put(self, table: str, row_id: int, row: np.ndarray) -> None:
        key = (table, row_id)
        with self._lock:
            self._rows[key] = np.array(row, copy=True)
            self._rows.move_to_end(key)
            while len(self._rows) > self.capacity:
                self._rows.popitem(last=False)

    def clear(self) -> None:
        with self._lock:
            self._rows.clear()


class SparseServeConfig:
    """What a replica passes to ``add_model(..., sparse=)``: where the
    rows live and how to pull them. Owns ONE read-only PSClient shared
    by every version/model it builds plans for (sockets and wire-codec
    negotiation survive hot swaps; only the row CACHE is per-version)."""

    def __init__(self, endpoints: Sequence[str],
                 comm_quant: Optional[str] = None,
                 cache_rows: int = DEFAULT_CACHE_ROWS,
                 replicas: Optional[Dict[str, Sequence[str]]] = None,
                 retry=None, deadline: Optional[float] = 10.0,
                 client=None):
        from ..pserver.client import PSClient

        self.endpoints = list(endpoints)
        self.cache_rows = int(cache_rows)
        self._own_client = client is None
        self.client = client if client is not None else PSClient(
            self.endpoints, comm_quant=comm_quant, replicas=replicas,
            retry=retry, deadline=deadline, read_only=True)

    def build(self, sparse_meta: dict, ver) -> "SparseLookupPlan":
        """ModelRegistry hook: one plan (and one row cache) per loaded
        ModelVersion."""
        return SparseLookupPlan(self.client, sparse_meta,
                                model=ver.name,
                                version_key=ver.version_key,
                                cache_rows=self.cache_rows)

    def close(self):
        if self._own_client:
            self.client.close()


class SparseLookupPlan:
    """The per-version read path: augment a padded batch's feeds with
    prefetched sub-tables. Tables sharing an ids feed share one
    uniq/remap (a fed ids var holds exactly one mapping) — the same
    grouping rule as the training-side AsyncPSTrainer."""

    def __init__(self, client, sparse_meta: dict, model: str,
                 version_key: str, cache_rows: int = DEFAULT_CACHE_ROWS):
        from ..pserver.trainer import AsyncPSTrainer

        self.client = client
        self.model = model
        self.version_key = version_key
        self.cap = int(sparse_meta["cap"])
        self.tables: Dict[str, dict] = dict(sparse_meta["tables"])
        self.groups: List[dict] = AsyncPSTrainer._group_tables(self.tables)
        self.cache = RowCache(cache_rows)
        self.hits = 0          # plan-local tallies for stats()/tests
        self.misses = 0
        self._m_hits = _metrics.counter(
            "fleet_sparse_cache_hits_total",
            "serve-time sparse lookups answered from the row cache")
        self._m_miss = _metrics.counter(
            "fleet_sparse_cache_misses_total",
            "serve-time sparse lookups pulled from pserver shards")
        self._m_rows = _metrics.gauge(
            "fleet_sparse_cache_rows", "rows held in the serve row cache")

    # -- warmup (no RPC) ---------------------------------------------------

    def warm_feeds(self, feeds: Dict[str, np.ndarray]
                   ) -> Dict[str, np.ndarray]:
        """The warm-compile twin of augment(): identical feed NAMES and
        SHAPES (zero sub-tables, untouched ids) so warmed signatures
        cover steady-state traffic — and not a single pserver RPC at
        load time."""
        feeds = dict(feeds)
        for wname, spec in self.tables.items():
            feeds[wname] = np.zeros((self.cap, spec["width"]),
                                    dtype=spec["dtype"])
        return feeds

    # -- the request path --------------------------------------------------

    def augment(self, feeds: Dict[str, np.ndarray]
                ) -> Dict[str, np.ndarray]:
        """Resolve one padded batch: per table group, unique the ids,
        pull rows (cache first), feed the [cap, width] sub-table under
        the table's name and the remapped ids under the ids feeds'
        names. Runs on the model's executor thread — the cache is what
        keeps the hot-id common case RPC-free."""
        feeds = dict(feeds)
        for g in self.groups:
            ids_vals = [np.asarray(feeds[n]) for n in g["ids_names"]]
            flat = np.concatenate([v.reshape(-1) for v in ids_vals])
            uniq, inv = np.unique(flat, return_inverse=True)
            m = int(uniq.shape[0])
            if m > self.cap:
                raise BadRequestError(
                    f"model {self.model!r}: batch touches {m} unique rows "
                    f"of {g['tables']} but the manifest's sparse cap is "
                    f"{self.cap} — lower the rows ladder or re-save with "
                    f"a larger cap")
            for wname in g["tables"]:
                spec = self.tables[wname]
                sub = np.zeros((self.cap, spec["width"]),
                               dtype=spec["dtype"])
                if m:
                    sub[:m] = self._rows_for(wname, uniq)
                feeds[wname] = sub
            off = 0
            for n, v in zip(g["ids_names"], ids_vals):
                feeds[n] = inv[off:off + v.size].reshape(v.shape) \
                    .astype(v.dtype)
                off += v.size
        return feeds

    def _rows_for(self, wname: str, uniq: np.ndarray) -> np.ndarray:
        spec = self.tables[wname]
        rows = np.empty((uniq.shape[0], spec["width"]),
                        dtype=spec["dtype"])
        missing: List[int] = []
        for j, rid in enumerate(uniq.tolist()):
            cached = self.cache.get(wname, rid)
            if cached is None:
                missing.append(j)
            else:
                rows[j] = cached
        hits = uniq.shape[0] - len(missing)
        if hits:
            self.hits += hits
            self._m_hits.inc(hits, model=self.model, table=wname)
        if missing:
            self.misses += len(missing)
            self._m_miss.inc(len(missing), model=self.model, table=wname)
            miss_ids = uniq[missing]
            pulled = self.client.prefetch_rows(wname, miss_ids)
            rows[missing] = pulled
            for j, rid in zip(missing, miss_ids.tolist()):
                self.cache.put(wname, rid, rows[j])
            self._m_rows.set(len(self.cache), model=self.model)
        return rows

    # -- lifecycle ---------------------------------------------------------

    def invalidate(self) -> None:
        """Drop every cached row (out-of-band refresh; the normal
        invalidation is the version swap retiring this whole plan)."""
        self.cache.clear()
        self._m_rows.set(0, model=self.model)

    def close(self) -> None:
        self.invalidate()

    def stats(self) -> dict:
        return {
            "cap": self.cap,
            "tables": sorted(self.tables),
            "cached_rows": len(self.cache),
            "cache_hits": self.hits,
            "cache_misses": self.misses,
        }

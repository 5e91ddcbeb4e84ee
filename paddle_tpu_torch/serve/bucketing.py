"""Shape-bucketing planner: pad requests onto a warm ladder of shapes.

Copy of ``paddle_tpu/serve/bucketing.py``. The registry runs the model
once at every rung of its ladder when it loads a version, so the first
request of each shape finds every kernel built and every cuDNN algorithm
chosen; the planner quantizes each request onto that ladder:

- the ROWS ladder buckets the batch dim (axis 0, the coalescing axis):
  a batch of 3 coalesced requests pads with zero rows up to the smallest
  rung >= 3;
- per-feed DIM ladders bucket any other dynamic (-1) axis the model
  declares (sequence lengths, variable spatial dims): each request's
  extent pads up to its rung, shared across the batch it joins.

Requests stay numpy arrays on the host until a coalesced batch is fed:
the executor makes one host-to-device copy a feed a batch.

Padding is zeros. For the row-wise programs serving targets (each output
row a function of the same input row — fc/conv/softmax pipelines in
`is_test` mode), padded rows cannot perturb real rows, so a sliced output
equals an unpadded run of the same rows.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core import ir
from .errors import BadRequestError

# rungs double: warm runs stay logarithmic in the max batch while
# padding waste is bounded by <2x rows (and far less at occupancy)
DEFAULT_ROWS_LADDER = (1, 2, 4, 8, 16)

# warm-up combination guard: rows rungs x per-dim rungs multiply
MAX_WARM_BUCKETS = 64


class BucketLadder:
    """The shape quantization config of one served model.

    `rows`: ascending batch-dim rungs; the largest is also the
    micro-batcher's max coalesced batch. `dims`: {feed_name: {axis:
    rungs}} ladders for non-batch dynamic axes (axis counted on the full
    array, so the first sequence axis of a [batch, time, d] feed is 1).
    """

    def __init__(self, rows: Sequence[int] = DEFAULT_ROWS_LADDER,
                 dims: Optional[Dict[str, Dict[int, Sequence[int]]]] = None):
        if not rows or any(r <= 0 for r in rows):
            raise ValueError(f"rows ladder must be positive ints, got {rows!r}")
        self.rows = tuple(sorted(set(int(r) for r in rows)))
        self.dims = {name: {int(ax): tuple(sorted(set(int(r) for r in rungs)))
                            for ax, rungs in axes.items()}
                     for name, axes in (dims or {}).items()}

    @property
    def max_rows(self) -> int:
        return self.rows[-1]

    def rows_rung(self, n: int) -> int:
        """Smallest rung >= n; raises BadRequestError past the ladder."""
        for r in self.rows:
            if r >= n:
                return r
        raise BadRequestError(
            f"request has {n} rows but the ladder tops out at "
            f"{self.max_rows} — split the request or extend the ladder")

    @classmethod
    def from_trace(cls, trace, max_rungs: int = 8, dim_max_rungs: int = 4,
                   max_warm: int = MAX_WARM_BUCKETS) -> "BucketLadder":
        """Derive the ladder FROM TRAFFIC instead of hand-configuring
        it. `trace` is a request-shape trace — the dict `load_trace`
        returns (or a bare list of its ``requests`` entries): each
        request records its row count and the extent of every dynamic
        non-batch axis.

        Rung selection is the exact padding-waste-minimizing partition
        (`optimal_rungs`): per axis, ≤ `max_rungs` (rows) /
        `dim_max_rungs` (each dynamic dim) rung values minimizing total
        padded units over the trace. The warm-up budget is enforced up
        front: the rows ladder shrinks until rows-rungs × dim-rung
        combinations fit `max_warm`, so the derived ladder always warms
        (`warm_feed_shapes` cannot raise) and traffic shaped like the
        trace meets only warmed shapes.

        Model note: this minimizes REQUEST-level padding. Coalescing
        packs multiple requests per batch, so measured per-batch waste
        under load is at or below this bound."""
        reqs = trace.get("requests") if isinstance(trace, dict) else trace
        if not reqs:
            raise BadRequestError("from_trace: empty request trace")
        # per-axis extents, each weighted by the request's CELL count
        # over the other axes (rows x other dims): the DP then minimizes
        # padded cells — predicted_padding_waste's exact objective — not
        # per-axis padded units (which lets a rarely-hit-but-huge axis
        # combination dominate the real waste)
        def _cells(r, skip=None):
            w = float(r["rows"])
            for feed, axes in (r.get("dims") or {}).items():
                for ax, extent in axes.items():
                    if (feed, int(ax)) != skip:
                        w *= int(extent)
            return w

        rows, rows_w = [], []
        for r in reqs:
            rows.append(int(r["rows"]))
            rows_w.append(_cells(r) / max(int(r["rows"]), 1))
        dim_extents: Dict[Tuple[str, int], List[int]] = {}
        dim_weights: Dict[Tuple[str, int], List[float]] = {}
        for r in reqs:
            for feed, axes in (r.get("dims") or {}).items():
                for ax, extent in axes.items():
                    key = (feed, int(ax))
                    dim_extents.setdefault(key, []).append(int(extent))
                    dim_weights.setdefault(key, []).append(
                        _cells(r, skip=key))
        dims: Dict[str, Dict[int, Tuple[int, ...]]] = {}
        combos = 1
        for (feed, ax), extents in sorted(dim_extents.items()):
            rungs = optimal_rungs(extents, dim_max_rungs,
                                  weights=dim_weights[(feed, ax)])
            dims.setdefault(feed, {})[ax] = rungs
            combos *= len(rungs)
        if combos > max_warm:
            raise BadRequestError(
                f"from_trace: {combos} dim-rung combinations exceed the "
                f"{max_warm} warm-compile budget even before the rows "
                f"ladder — lower dim_max_rungs")
        rows_budget = min(int(max_rungs), max(1, max_warm // combos))
        return cls(rows=optimal_rungs(rows, rows_budget, weights=rows_w),
                   dims=dims)

    def dim_rung(self, name: str, axis: int, extent: int) -> int:
        rungs = self.dims.get(name, {}).get(axis)
        if not rungs:
            # no ladder declared for this dynamic axis: serve the extent
            # as-is (each distinct extent is its own unwarmed shape)
            return extent
        for r in rungs:
            if r >= extent:
                return r
        raise BadRequestError(
            f"feed {name!r} axis {axis} extent {extent} exceeds its "
            f"ladder {rungs} — extend the ladder or reject upstream")


def feed_spec(program: ir.Program, feed_names: Sequence[str]
              ) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """{feed name: (declared shape, dtype)} for a loaded inference
    program. LoD feeds are rejected: their (data, lengths) @SEQLEN
    expansion is a contract the batcher doesn't model."""
    blk = program.global_block()
    spec = {}
    for name in feed_names:
        v = blk.vars.get(name)
        if v is None:
            raise BadRequestError(
                f"model declares feed {name!r} but the program has no "
                f"such variable")
        if v.lod_level > 0:
            raise BadRequestError(
                f"feed {name!r} is a LoD (variable-length sequence) "
                f"input — not servable through the micro-batcher; pad "
                f"upstream and re-save with lod_level=0")
        spec[name] = (tuple(v.shape), str(v.dtype or "float32"))
    return spec


class PlannedRequest:
    """One request after shape planning: per-feed arrays padded on every
    non-batch dynamic axis, plus the group signature that decides which
    queue (and therefore which coalesced batch) it can join."""

    __slots__ = ("feeds", "rows", "group_key")

    def __init__(self, feeds: Dict[str, np.ndarray], rows: int,
                 group_key: Tuple):
        self.feeds = feeds
        self.rows = rows
        self.group_key = group_key


def plan_request(spec: Dict[str, Tuple[Tuple[int, ...], str]],
                 ladder: BucketLadder,
                 feed: Dict[str, np.ndarray]) -> PlannedRequest:
    """Validate + pad one request's non-batch axes onto the ladder."""
    if set(feed) != set(spec):
        raise BadRequestError(
            f"feed names {sorted(feed)} != model feeds {sorted(spec)}")
    rows = None
    planned: Dict[str, np.ndarray] = {}
    key: List = []
    for name in sorted(spec):
        shape, dtype = spec[name]
        arr = np.asarray(feed[name])
        if arr.ndim != len(shape):
            raise BadRequestError(
                f"feed {name!r} has rank {arr.ndim}, model declares "
                f"rank {len(shape)} ({shape})")
        if rows is None:
            rows = int(arr.shape[0])
            if rows <= 0:
                raise BadRequestError(f"feed {name!r} has zero rows")
        elif arr.shape[0] != rows:
            raise BadRequestError(
                f"feed {name!r} has {arr.shape[0]} rows; other feeds "
                f"have {rows} — batch dims must agree")
        pad = [(0, 0)] * arr.ndim
        padded_tail = []
        for ax in range(1, arr.ndim):
            declared = shape[ax] if ax < len(shape) else -1
            extent = int(arr.shape[ax])
            if declared == -1:
                target = ladder.dim_rung(name, ax, extent)
                pad[ax] = (0, target - extent)
                padded_tail.append(target)
            else:
                if extent != declared:
                    raise BadRequestError(
                        f"feed {name!r} axis {ax} extent {extent} != "
                        f"declared static {declared}")
                padded_tail.append(extent)
        if any(p != (0, 0) for p in pad):
            arr = np.pad(arr, pad)
        if str(arr.dtype) != dtype:
            # mirror DataFeeder's implicit numeric cast so a float64
            # client payload joins the float32 group of its shape
            if arr.dtype.kind in "fiub":
                arr = arr.astype(dtype)
            else:
                raise BadRequestError(
                    f"feed {name!r} dtype {arr.dtype} not castable to "
                    f"declared {dtype}")
        planned[name] = arr
        key.append((name, tuple(padded_tail), dtype))
    # rows above the top rung can never run; reject at the door so the
    # queue doesn't accept work the executor must bounce later
    ladder.rows_rung(rows)
    return PlannedRequest(planned, rows, tuple(key))


def pad_rows(arrays: Dict[str, np.ndarray], rows: int,
             target: int) -> Dict[str, np.ndarray]:
    """Zero-pad every array's axis 0 from `rows` to `target`."""
    if target == rows:
        return arrays
    out = {}
    for name, arr in arrays.items():
        pad = [(0, 0)] * arr.ndim
        pad[0] = (0, target - rows)
        out[name] = np.pad(arr, pad)
    return out


def concat_requests(reqs: Sequence[PlannedRequest]
                    ) -> Tuple[Dict[str, np.ndarray], int]:
    """Coalesce same-group requests along axis 0. Returns (feeds, rows)."""
    if len(reqs) == 1:
        return dict(reqs[0].feeds), reqs[0].rows
    names = reqs[0].feeds.keys()
    feeds = {n: np.concatenate([r.feeds[n] for r in reqs], axis=0)
             for n in names}
    return feeds, sum(r.rows for r in reqs)


def optimal_rungs(extents: Sequence[int], max_rungs: int,
                  weights: Optional[Sequence[float]] = None
                  ) -> Tuple[int, ...]:
    """Choose ≤ `max_rungs` rung values covering every observed extent,
    minimizing total padding Σ w_i·(rung(x_i) − x_i). Rungs only ever
    need to sit AT observed extents (lowering a rung to the next
    observed value below it never increases padding), so this is an
    exact O(m²·K) partition DP over the m unique extents."""
    if max_rungs < 1:
        raise ValueError(f"max_rungs must be >= 1, got {max_rungs}")
    xs = [int(x) for x in extents]
    if not xs:
        return ()
    if any(x <= 0 for x in xs):
        raise ValueError("extents must be positive")
    ws = [float(w) for w in weights] if weights is not None \
        else [1.0] * len(xs)
    if len(ws) != len(xs):
        raise ValueError("weights must match extents")
    agg: Dict[int, float] = {}
    for x, w in zip(xs, ws):
        agg[x] = agg.get(x, 0.0) + w
    uniq = sorted(agg)
    m = len(uniq)
    k = min(int(max_rungs), m)
    if k == m:
        return tuple(uniq)
    w_arr = np.array([agg[u] for u in uniq])
    u_arr = np.array(uniq, dtype=float)
    # cost[i][j]: extents (i..j] padded up to uniq[j] (i exclusive)
    cum_w = np.concatenate([[0.0], np.cumsum(w_arr)])
    cum_wx = np.concatenate([[0.0], np.cumsum(w_arr * u_arr)])

    def seg_cost(i, j):  # pad uniq[i+1..j] to uniq[j]
        return (u_arr[j] * (cum_w[j + 1] - cum_w[i + 1])
                - (cum_wx[j + 1] - cum_wx[i + 1]))

    INF = float("inf")
    best = [[INF] * m for _ in range(k + 1)]
    back = [[-1] * m for _ in range(k + 1)]
    for j in range(m):
        best[1][j] = seg_cost(-1, j)
    for r in range(2, k + 1):
        for j in range(r - 1, m):
            for i in range(r - 2, j):
                c = best[r - 1][i] + seg_cost(i, j)
                if c < best[r][j]:
                    best[r][j] = c
                    back[r][j] = i
    # the top rung must be the max extent; fewer rungs never beat k here
    # (adding a rung can only reduce padding), so read off row k
    rungs = []
    j = m - 1
    r = k
    while j >= 0 and r >= 1:
        rungs.append(uniq[j])
        j = back[r][j]
        r -= 1
    return tuple(sorted(rungs))


TRACE_VERSION = 1


def trace_request(rows: int, dims: Optional[Dict[str, Dict[int, int]]]
                  = None, ts: Optional[float] = None) -> dict:
    """One request-shape trace entry in the `from_trace` format."""
    return {"ts": float(ts or 0.0), "rows": int(rows),
            "dims": {feed: {int(ax): int(e) for ax, e in axes.items()}
                     for feed, axes in (dims or {}).items()}}


def save_trace(path: str, requests: Sequence[dict]) -> None:
    """Write a request-shape trace: one JSON document,
    `{"version": 1, "requests": [{ts, rows, dims}, ...]}`."""
    with open(path, "w") as f:
        json.dump({"version": TRACE_VERSION,
                   "requests": list(requests)}, f)


def load_trace(path: str) -> dict:
    """Read a `save_trace` document; validates the shape `from_trace`
    consumes and raises BadRequestError naming what is malformed."""
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or "requests" not in doc:
        raise BadRequestError(
            f"trace {path!r}: expected a JSON object with a 'requests' "
            f"list (save_trace / --emit-trace format)")
    for i, r in enumerate(doc["requests"]):
        if not isinstance(r, dict) or "rows" not in r:
            raise BadRequestError(
                f"trace {path!r}: request {i} has no 'rows' field")
    return doc


def predicted_padding_waste(ladder: BucketLadder, trace) -> float:
    """The request-level padded-unit fraction the ladder implies for a
    trace: 1 − Σ(real cells)/Σ(padded cells), counting the rows axis ×
    every traced dynamic axis. This is `from_trace`'s objective — an
    upper-bound-flavored proxy for the batcher's measured per-batch
    `serve_padding_waste_ratio` (coalescing only packs batches fuller)."""
    reqs = trace.get("requests") if isinstance(trace, dict) else trace
    real = padded = 0.0
    for r in reqs:
        rows = int(r["rows"])
        cells, pcells = float(rows), float(ladder.rows_rung(rows))
        for feed, axes in (r.get("dims") or {}).items():
            for ax, extent in axes.items():
                cells *= int(extent)
                pcells *= ladder.dim_rung(feed, int(ax), int(extent))
        real += cells
        padded += pcells
    return 1.0 - real / padded if padded else 0.0


def warm_feed_shapes(spec: Dict[str, Tuple[Tuple[int, ...], str]],
                     ladder: BucketLadder
                     ) -> List[Dict[str, np.ndarray]]:
    """Zero feed dicts covering every (rows rung x dim-rung combo) the
    planner can emit — the ahead-of-time warm set. Combination count is
    capped at MAX_WARM_BUCKETS (a ladder that big is a config smell; the
    registry raises rather than warming for an hour)."""
    # per-feed resolved tail-shape choices
    per_feed: Dict[str, List[Tuple[int, ...]]] = {}
    for name in sorted(spec):
        shape, _ = spec[name]
        choices: List[List[int]] = [[]]
        for ax in range(1, len(shape)):
            if shape[ax] == -1:
                rungs = ladder.dims.get(name, {}).get(ax)
                if not rungs:
                    raise BadRequestError(
                        f"feed {name!r} axis {ax} is dynamic (-1) but the "
                        f"ladder declares no rungs for it — warmup cannot "
                        f"enumerate its shapes (pass dims={{{name!r}: "
                        f"{{{ax}: (...)}}}})")
                choices = [c + [r] for c in choices for r in rungs]
            else:
                choices = [c + [int(shape[ax])] for c in choices]
        per_feed[name] = [tuple(c) for c in choices]
    # cartesian product across feeds' tail choices x rows rungs
    combos: List[Dict[str, Tuple[int, ...]]] = [{}]
    for name, tails in per_feed.items():
        combos = [dict(c, **{name: t}) for c in combos for t in tails]
        if len(combos) * len(ladder.rows) > MAX_WARM_BUCKETS:
            raise BadRequestError(
                f"bucket ladder enumerates more than {MAX_WARM_BUCKETS} "
                f"warm compiles — shrink the rows/dims ladders")
    out = []
    for rows in ladder.rows:
        for combo in combos:
            out.append({name: np.zeros((rows,) + combo[name],
                                       dtype=spec[name][1])
                        for name in spec})
    return out

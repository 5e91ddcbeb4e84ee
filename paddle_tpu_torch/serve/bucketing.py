"""Shape-bucketing ladder: the prompt shapes the serving registry warms.

Copy of the parts of ``paddle_tpu/serve/bucketing.py`` generative serving
uses. A prefill step's feed shape is (rows, prompt length); the ladder
quantizes both onto a few rungs — the ROWS ladder buckets the batch dim,
per-feed DIM ladders bucket the prompt length — and the registry runs
every rung once at load (`warm_feed_shapes`), so the kernels are built
and launched before traffic arrives.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core import ir
from .errors import BadRequestError

# rungs double: warm runs stay logarithmic in the max batch while
# padding waste is bounded by <2x rows
DEFAULT_ROWS_LADDER = (1, 2, 4, 8, 16)

# warm-up combination guard: rows rungs x per-dim rungs multiply
MAX_WARM_BUCKETS = 64


class BucketLadder:
    """The shape quantization config of one served model.

    `rows`: ascending batch-dim rungs; the largest is also the most
    prompts one prefill step takes. `dims`: {feed_name: {axis:
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

    def dim_rung(self, name: str, axis: int, extent: int) -> int:
        rungs = self.dims.get(name, {}).get(axis)
        if not rungs:
            # no ladder declared for this dynamic axis: serve the extent
            # as-is
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
    program. LoD feeds are rejected (not ported)."""
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
                f"input — pad upstream and re-save with lod_level=0")
        spec[name] = (tuple(v.shape), str(v.dtype or "float32"))
    return spec


def warm_feed_shapes(spec: Dict[str, Tuple[Tuple[int, ...], str]],
                     ladder: BucketLadder
                     ) -> List[Dict[str, np.ndarray]]:
    """Zero feed dicts covering every (rows rung x dim-rung combo) the
    planner can emit — the ahead-of-time warm set. Combination count is
    capped at MAX_WARM_BUCKETS (a ladder that big is a config smell; the
    registry raises rather than compiling for an hour)."""
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

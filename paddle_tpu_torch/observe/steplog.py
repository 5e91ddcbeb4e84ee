"""Per-step phase accounting + the plan-build observatory.

Copy of ``paddle_tpu/observe/steplog.py``. Two runtime questions:

1. *Where does a step's host time go?* `StepStats` records the host wall
   time of each phase of one `PreparedProgram.run` / `ParallelExecutor`
   run when the `observe` flag is on — feed conversion, state gather,
   the block's run, state write-back, fetch — under the JAX package's
   phase names, with their host-wall meaning. On a card the port runs
   the block eagerly: `device_compute` is the wall of the interpreter
   that queues the block's kernels, not of the card's work, and the
   wait for the card falls in `fetch` (the first copy to the host), or
   in a later step's phases when nothing is fetched. Nothing here
   synchronizes the card.

2. *Why did the executor build a step again?* The port compiles
   nothing; the counterpart of the JAX package's compile-cache miss is
   a new step plan (``core/executor.py``'s `_StepPlan`), built once per
   (program, version, feed names, fetch list, scope). Each build is
   recorded with its attributed cause, under the JAX package's names,
   so the serving registry's warm shapes, `RecompileDetector`
   (``observe/health.py``) and ``executor_recompiles_total`` keep their
   meaning:

   - ``first_call``       first plan of this program (expected)
   - ``feed_shape``       same feed names, new shapes/dtypes. A new
                          shape costs the port nothing (the eager
                          block takes any shape); it is recorded as
                          the JAX package records it, where it is a
                          retrace and a recompile
   - ``program_version``  the program was mutated after its plan
   - ``copts_change``     never recorded by the port: it has no
                          compiler options; the name is kept for the
                          shared vocabulary
   - ``feed_names``       a different set of feed variables was bound
   - ``fetch_set``        a different fetch list needed a new plan
   - ``new_scope``        the same program bound against a different
                          Scope (train/test scopes, per-request scopes)
   - ``options_change``   every observed key matched yet a plan was
                          built (the JAX package: an amp / check_nan_inf
                          / dropout_impl / random_seed flip; the port
                          bakes none of these into a plan)
   - ``uncached``         the JAX package's use_program_cache=False
                          path; the port has no such path and never
                          records it
   - ``warmup``           a run the serving layer (serve/) deliberately
                          provoked while warming a bucket ladder —
                          expected, like ``first_call``
   - ``padding_bucket``   a shape miss on a ``serving``-source handle:
                          the request's padded shape was NOT in the
                          warmed bucket ladder. Same mechanism as
                          ``feed_shape`` but attributed separately so a
                          mis-sized ladder is told from a cache bug

   Plan-build events are recorded regardless of the `observe` flag — a
   build is once per key, the record costs microseconds. Only the
   per-step shape *tracking* that detects `feed_shape` misses is
   flag-gated (it is on the hot path).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from . import flight as _flight
from . import metrics as _metrics
from . import tracer as _tracer

PHASES = ("feed_convert", "state_gather", "device_compute", "write_back",
          "fetch", "bind")


class StepStats:
    """Host-side phase wall times (seconds) of one run()."""

    __slots__ = ("program_uid", "source", "ts", "phases", "total")

    def __init__(self, program_uid: int, source: str, ts: float,
                 phases: Dict[str, float]):
        self.program_uid = program_uid
        self.source = source          # "executor" | "parallel"
        self.ts = ts
        self.phases = phases
        self.total = sum(phases.values())

    def as_dict(self) -> dict:
        return {"program_uid": self.program_uid, "source": self.source,
                "ts": self.ts, "total_us": round(self.total * 1e6, 2),
                "phases_us": {k: round(v * 1e6, 2)
                              for k, v in self.phases.items()}}


class StepLog:
    """Bounded record of recent StepStats + running per-phase totals."""

    def __init__(self, capacity: int = 1024):
        self._steps: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._totals = {p: 0.0 for p in PHASES}
        self._count = 0
        # (registry generation, counter, histogram): resolved once per
        # registry generation instead of two get-or-create registry-lock
        # round trips on every observed step
        self._mcache = None

    def _metric_handles(self):
        reg = _metrics.default_registry()
        gen = reg.generation()
        mc = self._mcache
        if mc is None or mc[0] != gen:
            mc = self._mcache = (
                gen,
                reg.counter("executor_steps_total",
                            "run() calls instrumented by the steplog"),
                reg.histogram("executor_step_phase_us",
                              "host wall time per step phase "
                              "(microseconds)"))
        return mc[1], mc[2]

    def record(self, stats: StepStats, emit_metrics: bool = True,
               emit_trace: bool = True):
        with self._lock:
            self._steps.append(stats)
            for p, v in stats.phases.items():
                self._totals[p] = self._totals.get(p, 0.0) + v
            self._count += 1
        if emit_metrics:
            c, h = self._metric_handles()
            c.inc(source=stats.source)
            for p, v in stats.phases.items():
                h.observe(v * 1e6, phase=p, source=stats.source)
        if emit_trace:
            _tracer.get_tracer().record(
                "step", stats.ts, stats.total, cat="step",
                **{f"{k}_us": round(v * 1e6, 2)
                   for k, v in stats.phases.items()})
        # flight recorder: callers only invoke record() when observing,
        # so this rides the same gate as the metric writes
        _flight.note("step", program_uid=stats.program_uid,
                     source=stats.source,
                     total_us=round(stats.total * 1e6, 2))

    def recent(self, n: int = 16) -> List[StepStats]:
        with self._lock:
            return list(self._steps)[-n:]

    def phase_summary(self, reset: bool = False) -> dict:
        """Aggregated per-phase totals (µs) since the last reset."""
        with self._lock:
            out = {"steps": self._count,
                   "phase_us": {p: round(v * 1e6, 2)
                                for p, v in self._totals.items() if v},
                   "mean_step_us": round(
                       sum(self._totals.values()) * 1e6
                       / max(self._count, 1), 2)}
            if reset:
                self._totals = {p: 0.0 for p in PHASES}
                self._count = 0
        return out

    def clear(self):
        with self._lock:
            self._steps.clear()
            self._totals = {p: 0.0 for p in PHASES}
            self._count = 0


class RecompileEvent:
    __slots__ = ("ts", "program_uid", "cause", "source", "detail")

    def __init__(self, ts, program_uid, cause, source, detail):
        self.ts = ts
        self.program_uid = program_uid
        self.cause = cause
        self.source = source
        self.detail = detail

    def as_dict(self) -> dict:
        return {"ts": self.ts, "program_uid": self.program_uid,
                "cause": self.cause, "source": self.source,
                "detail": self.detail}

    def __repr__(self):
        return (f"RecompileEvent(uid={self.program_uid}, "
                f"cause={self.cause!r}, source={self.source!r})")


# causes that are expected on a healthy steady-state run and therefore
# ignored by --assert-no-recompiles (the first compile of each program
# has to happen, and a serving warmup compiles its bucket ladder ahead
# of traffic on purpose; everything else is a recompile someone should
# explain)
EXPECTED_CAUSES = ("first_call", "warmup")


class RecompilationObservatory:
    """Records every executor-level plan build with an attributed cause.

    Attribution compares the miss against what this process has already
    compiled for the same program uid, in priority order: new version →
    ``program_version``; new compiler options → ``copts_change``; new
    feed-name set → ``feed_names``; new fetch list → ``fetch_set``; new
    scope → ``new_scope``; anything else that re-keyed the compile cache
    (amp / check_nan_inf / dropout_impl / random_seed flips) →
    ``options_change``. Run-time shape tracking (flag-gated, see note in
    the module docstring) reports a new feed signature on an
    already-bound entry as ``feed_shape``."""

    def __init__(self, capacity: int = 256):
        self._events: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        # program uid -> {"versions", "copts", "feed_sigs", "fetch_sigs",
        #                 "scopes"}
        self._seen: Dict[int, dict] = {}

    def note_entry_build(self, program_uid: int, version: int,
                         feed_sig: Tuple, fetch_sig: Tuple, copts_sig,
                         source: str = "executor",
                         scope_uid=None) -> str:
        """Called on every new step plan the executor builds (the JAX
        package's compile-cache miss). Returns the cause."""
        with self._lock:
            s = self._seen.get(program_uid)
            if s is None:
                cause = "first_call"
                s = self._seen[program_uid] = {
                    "versions": set(), "copts": set(),
                    "feed_sigs": set(), "fetch_sigs": set(),
                    "scopes": set()}
            elif version not in s["versions"]:
                cause = "program_version"
            elif copts_sig not in s["copts"]:
                cause = "copts_change"
            elif feed_sig not in s["feed_sigs"]:
                cause = "feed_names"
            elif fetch_sig not in s["fetch_sigs"]:
                cause = "fetch_set"
            elif scope_uid is not None and scope_uid not in s["scopes"]:
                cause = "new_scope"
            else:
                # every observed key dimension matched, so the re-key came
                # from an executor-setting flip (amp / check_nan_inf /
                # dropout_impl / random_seed)
                cause = "options_change"
            s["versions"].add(version)
            s["copts"].add(copts_sig)
            s["feed_sigs"].add(feed_sig)
            s["fetch_sigs"].add(fetch_sig)
            if scope_uid is not None:
                s["scopes"].add(scope_uid)
            self._events.append(RecompileEvent(
                time.time(), program_uid, cause, source,
                {"version": version, "feeds": list(feed_sig),
                 "fetches": list(fetch_sig)}))
        self._emit_metric(cause, source)
        return cause

    def note_shape_miss(self, program_uid: int, shape_sig, source: str,
                        cause: str = "feed_shape"):
        """A bound entry saw a NEW feed shape/dtype signature: where the
        JAX package retraces and recompiles. This is the live
        counterpart of the lint's feed-shape recompile hazard. On a
        ``serving``-source handle the caller attributes it
        ``padding_bucket`` instead — the bucket planner should have
        padded the request onto a warmed rung, so a miss means the
        ladder is mis-sized."""
        with self._lock:
            self._events.append(RecompileEvent(
                time.time(), program_uid, cause, source,
                {"shapes": {n: list(shp)
                            for n, shp, _ in shape_sig}}))
        self._emit_metric(cause, source)

    def record(self, program_uid: int, cause: str, source: str,
               detail=None):
        """Direct record without attribution (e.g. `uncached` runs)."""
        with self._lock:
            self._events.append(RecompileEvent(
                time.time(), program_uid, cause, source, detail))
        self._emit_metric(cause, source)

    @staticmethod
    def _emit_metric(cause: str, source: str):
        _metrics.counter(
            "executor_recompiles_total",
            "executor compile events by attributed cause").inc(
                cause=cause, source=source)
        # plan builds are never hot — they go to the black box
        # unconditionally, like the metric above
        _flight.note("compile", cause=cause, source=source)

    def events(self) -> List[RecompileEvent]:
        with self._lock:
            return list(self._events)

    def counts(self) -> Dict[str, int]:
        """Per-cause counts over the BOUNDED event ring — right for short
        runs and detail inspection. For cumulative whole-run counts read
        the `executor_recompiles_total` metrics counter instead (events
        older than the ring capacity fall out of this tally)."""
        out: Dict[str, int] = {}
        for e in self.events():
            out[e.cause] = out.get(e.cause, 0) + 1
        return out

    def unexpected(self) -> List[RecompileEvent]:
        """Events whose cause is not in EXPECTED_CAUSES — the set
        --assert-no-recompiles fails on."""
        return [e for e in self.events() if e.cause not in EXPECTED_CAUSES]

    def clear(self):
        with self._lock:
            self._events.clear()
            self._seen.clear()


_steplog = StepLog()
_observatory = RecompilationObservatory()


def get_steplog() -> StepLog:
    return _steplog


def observatory() -> RecompilationObservatory:
    return _observatory


def shape_sig(feed_arrays: Dict) -> Tuple:
    """Canonical (name, shape, dtype) signature of a feed dict — the part
    of a step's key the executor can observe cheaply. A torch dtype
    reads as numpy's name (``torch.float32`` -> ``float32``), so a numpy
    feed and the tensor it converts to have one signature."""
    return tuple(sorted(
        (n, tuple(getattr(v, "shape", ())),
         str(getattr(v, "dtype", "")).replace("torch.", ""))
        for n, v in feed_arrays.items()))


def track_shapes(entry, program_uid: int, feed_arrays: Dict,
                 source: str = "executor"):
    """Flag-gated per-step shape tracking: detect new feed signatures on
    a bound entry (a retrace in the JAX package). The first signature an entry ever runs is covered by its
    build event; every NEW signature after that is a `feed_shape` miss —
    or, on a serving handle (where the bucket planner guarantees every
    steady-state shape was warmed ahead of time), a `padding_bucket`
    miss."""
    sig = shape_sig(feed_arrays)
    seen = getattr(entry, "_shape_sigs", None)
    if seen is None:
        seen = entry._shape_sigs = set()
    if sig not in seen:
        if seen:
            cause = "padding_bucket" if source == "serving" else "feed_shape"
            observatory().note_shape_miss(program_uid, sig, source, cause)
        seen.add(sig)


def preseed_shapes(entry, feed_arrays: Dict):
    """Register a feed signature as already-seen on a bound entry WITHOUT
    recording a shape-miss event. The serving warmup uses this: it runs
    each bucket shape once ahead of traffic (recording those compiles as
    the expected `warmup` cause via the observatory), and pre-seeding
    keeps the tracker from re-flagging the warmed shapes as misses —
    including when warmup ran with the `observe` flag off and the flag is
    flipped on later."""
    sig = shape_sig(feed_arrays)
    seen = getattr(entry, "_shape_sigs", None)
    if seen is None:
        seen = entry._shape_sigs = set()
    seen.add(sig)

"""fluid-pulse: metric time-series + online anomaly detection.

Rounds 8/11 made incidents readable after the fact; this module makes a
RUNNING process able to say "this run is going wrong" — the TF system
paper's per-task health story. Three pieces:

- ``TimeSeries``: a bounded ring of (ts, value) points, O(1) append,
  fed either directly (``feed``) or by riding the metrics registry's
  write path (``Registry.watch`` — counters contribute increments,
  gauges levels, histograms samples), enabling rates and derivatives
  without a second collection pipeline.

- Detectors: small stateful rules evaluated on demand (every /healthz
  or /status scrape, plus the pulse ticker) that flip between ok and
  firing. The built-in catalog (``install_default_detectors``):

  * ``non_finite_loss``      any non-finite point on the loss series
                             (sticky — NaN params don't self-heal)
  * ``grad_norm_spike``      latest grad norm above rolling
                             median + k*MAD of the trailing window
  * ``throughput_collapse``  recent step rate below a fraction of the
                             trailing-window rate
  * ``steady_state_recompile`` an unexpected observatory cause (not
                             warmup/first_call) after the grace steps
  * ``serve_queue_saturation`` queue depth >= 90% of capacity
  * ``kv_cache_exhaustion``  paged KV blocks (allocated + reserved)
                             >= 90% of capacity — generative admissions
                             are about to start bouncing
  * ``serve_deadline_miss``  deadline rejections above a windowed rate
  * ``ps_retry_storm``       client RPC retries above a windowed rate
  * ``lease_churn``          evictions+readmissions above a windowed rate
  * ``fleet_failover_storm`` router request failovers above a windowed
                             rate — replica membership is flapping
  * ``ps_replication_stall`` fluid-haven: the replication lag grows
                             monotonically over a window while pushes
                             keep landing — the backup stopped
                             keeping up (self-clears when the ack
                             watermark moves again)
  * ``quorum_loss``          fluid-quorum: a HELD lease cannot renew
                             against a strict majority of arbiters —
                             this holder is fenced (writes held) and
                             will step down at local expiry unless the
                             quorum comes back (self-clears on re-grant
                             or successful renew)
  * ``task_starvation``      fluid-elastic: the data master holds
                             outstanding tasks but no issue/finish
                             progress landed for a window — the data
                             plane is starved (self-clears)
  * ``task_discard``         fluid-elastic: a task burned its failure
                             budget and was discarded — its records
                             are silently lost for the pass (sticky)
  * ``wire_compression_collapse`` on-wire ratio fell to half of the
                             session's established ratio

- ``Alert``: a structured event fired ONCE per ok->firing transition —
  counted in the metrics registry (``health_alerts_total{rule=...}``)
  and recorded into the flight-recorder ring WITH the last points of
  the triggering series, so a postmortem dump shows why health went red
  before the crash.

Everything here is pull-evaluated and rides existing emit paths: with
the `observe` flag off nothing feeds the rings and nothing evaluates,
so the hot path stays at its zero-write contract.

Copy of ``paddle_tpu/observe/health.py``, its imports rewired to this
package.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from . import flight as _flight
from . import metrics as _metrics

DEFAULT_SERIES_POINTS = 512
ALERTS_METRIC = "health_alerts_total"


class TimeSeries:
    """Bounded (ts, value) ring with the derived views detectors need."""

    def __init__(self, capacity: int = DEFAULT_SERIES_POINTS):
        self._points: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()

    def append(self, value: float, ts: Optional[float] = None):
        with self._lock:
            self._points.append((time.time() if ts is None else ts,
                                 float(value)))

    def points(self, n: Optional[int] = None) -> List[Tuple[float, float]]:
        with self._lock:
            pts = list(self._points)
        return pts if n is None else pts[-n:]

    def values(self, n: Optional[int] = None) -> List[float]:
        return [v for _, v in self.points(n)]

    def last(self) -> Optional[Tuple[float, float]]:
        with self._lock:
            return self._points[-1] if self._points else None

    def __len__(self):
        with self._lock:
            return len(self._points)

    def window_sum(self, window_s: float, now: Optional[float] = None,
                   end_offset_s: float = 0.0) -> Tuple[float, int]:
        """(sum, count) of points with ts in
        [now - end_offset - window, now - end_offset]."""
        now = time.time() if now is None else now
        hi = now - end_offset_s
        lo = hi - window_s
        s, n = 0.0, 0
        for ts, v in self.points():
            if lo < ts <= hi:
                s += v
                n += 1
        return s, n

    def rate(self, window_s: float, now: Optional[float] = None,
             end_offset_s: float = 0.0) -> float:
        """Sum of values in the window divided by the window — the
        events/sec (or units/sec) of an increment-fed series."""
        s, _ = self.window_sum(window_s, now=now, end_offset_s=end_offset_s)
        return s / max(window_s, 1e-9)

    def derivative(self) -> Optional[float]:
        """d(value)/dt across the last two points (level-fed series)."""
        pts = self.points(2)
        if len(pts) < 2:
            return None
        (t0, v0), (t1, v1) = pts
        if t1 <= t0:
            return None
        return (v1 - v0) / (t1 - t0)


def _median(vals: List[float]) -> float:
    s = sorted(vals)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


class Alert:
    """One fired health rule: what tripped, on what evidence."""

    __slots__ = ("rule", "metric", "observed", "threshold", "message",
                 "ts", "detail")

    def __init__(self, rule: str, metric: str, observed, threshold,
                 message: str, detail: Optional[dict] = None):
        self.rule = rule
        self.metric = metric
        self.observed = observed
        self.threshold = threshold
        self.message = message
        self.ts = time.time()
        self.detail = detail or {}

    def as_dict(self) -> dict:
        return {"rule": self.rule, "metric": self.metric,
                "observed": self.observed, "threshold": self.threshold,
                "message": self.message, "ts": self.ts,
                "detail": self.detail}

    def __repr__(self):
        return f"Alert({self.rule}: {self.message})"


class Detector:
    """Base rule: subclasses implement check() and call fire()/clear().
    `series` names the TimeSeries whose recent points ride along in the
    alert's flight-recorder record."""

    name = "detector"
    series: Optional[str] = None

    def check(self, engine: "HealthEngine", now: float) -> None:
        raise NotImplementedError

    def acknowledge(self, engine: "HealthEngine") -> None:
        """Operator remediation hook (engine.clear_alerts): a STICKY
        detector must re-baseline here so the cleared alert does not
        re-fire from the same old evidence on the next evaluate.
        Self-clearing detectors need nothing."""

    def state(self, engine: "HealthEngine") -> dict:
        """Introspection for /healthz check detail."""
        a = engine.active_alert(self.name)
        return {"firing": a is not None,
                **({"alert": a.as_dict()} if a else {})}


class NonFiniteDetector(Detector):
    """Any non-finite point on the series. STICKY: a NaN loss means the
    parameters are (or are about to be) poisoned — the alert never
    self-heals; after remediation an operator clears it with
    `engine.clear_alerts()` (or a full reset)."""

    def __init__(self, name: str = "non_finite_loss",
                 series: str = "train_loss"):
        self.name = name
        self.series = series
        # points at or before this ts are acknowledged history: after an
        # operator clear_alerts() the old NaN still on the ring must not
        # re-fire; only a NEW non-finite point is a new incident
        self._ack_ts = float("-inf")

    def check(self, engine, now):
        if engine.active_alert(self.name) is not None:
            return  # sticky
        ts = engine.series(self.series)
        for pt_ts, v in ts.points():
            if pt_ts <= self._ack_ts:
                continue
            if not math.isfinite(v):
                engine.fire(self, observed=v, threshold="finite",
                            message=f"non-finite value {v!r} on "
                                    f"{self.series}")
                return

    def acknowledge(self, engine):
        self._ack_ts = time.time()


class SpikeDetector(Detector):
    """Latest point above rolling median + k*MAD of the trailing window
    (robust z-score — one outlier in the history can't move the
    threshold much). Clears when the latest point is back under."""

    def __init__(self, name: str = "grad_norm_spike",
                 series: str = "grad_norm", window: int = 64,
                 k: float = 10.0, min_points: int = 8):
        self.name = name
        self.series = series
        self.window = window
        self.k = k
        self.min_points = min_points

    def check(self, engine, now):
        vals = engine.series(self.series).values(self.window + 1)
        if len(vals) < self.min_points:
            engine.clear(self)
            return
        cur, hist = vals[-1], vals[:-1]
        med = _median(hist)
        mad = _median([abs(v - med) for v in hist])
        # floor: a perfectly flat history has MAD 0 and any jitter would
        # fire — require at least a few percent of the median as spread
        thr = med + self.k * max(mad, 0.02 * abs(med), 1e-12)
        if math.isfinite(cur) and cur > thr:
            engine.fire(self, observed=cur, threshold=thr,
                        message=f"{self.series} {cur:.4g} above rolling "
                                f"median {med:.4g} + {self.k}*MAD")
        else:
            engine.clear(self)


class RateCollapseDetector(Detector):
    """Recent-window rate below `frac` of the trailing-window rate —
    throughput collapsed vs what this process was just sustaining.
    Needs a real trailing rate (min_trailing events) so an idle or
    just-started process never fires."""

    def __init__(self, name: str = "throughput_collapse",
                 series: str = "steps", recent_s: float = 5.0,
                 trailing_s: float = 30.0, frac: float = 0.25,
                 min_trailing: int = 20):
        self.name = name
        self.series = series
        self.recent_s = recent_s
        self.trailing_s = trailing_s
        self.frac = frac
        self.min_trailing = min_trailing

    def check(self, engine, now):
        ts = engine.series(self.series)
        pts = ts.points()
        if not pts:
            engine.clear(self)
            return
        # rates over the COVERED span only: a fast process wraps the
        # bounded ring in seconds, and dividing its partial window by
        # the full trailing_s would deflate the trailing rate and mask a
        # real collapse
        oldest = pts[0][0]
        recent_cov = max(min(self.recent_s, now - oldest), 1e-9)
        recent_sum, _ = ts.window_sum(self.recent_s, now=now)
        recent = recent_sum / recent_cov
        trail_hi = now - self.recent_s
        trail_cov = trail_hi - max(trail_hi - self.trailing_s, oldest)
        trail_sum, trail_n = ts.window_sum(self.trailing_s, now=now,
                                           end_offset_s=self.recent_s)
        if trail_n < self.min_trailing or trail_cov <= 0:
            # not enough trailing evidence to JUDGE — but a hang that
            # merely outlasts the trailing window is not recovery: while
            # firing, only actual steps in the recent window clear it
            if engine.active_alert(self.name) is None or recent > 0:
                engine.clear(self)
            return
        trailing = trail_sum / trail_cov
        if recent < self.frac * trailing:
            engine.fire(self, observed=round(recent, 3),
                        threshold=round(self.frac * trailing, 3),
                        message=f"{self.series} rate {recent:.2f}/s fell "
                                f"below {self.frac:.0%} of trailing "
                                f"{trailing:.2f}/s")
        else:
            engine.clear(self)


class RateSpikeDetector(Detector):
    """Windowed event count at or above a threshold (retry storms,
    deadline-miss bursts, lease churn). Clears when the window drains."""

    def __init__(self, name: str, series: str, window_s: float = 15.0,
                 threshold: float = 8.0):
        self.name = name
        self.series = series
        self.window_s = window_s
        self.threshold = threshold

    def check(self, engine, now):
        s, _ = engine.series(self.series).window_sum(self.window_s, now=now)
        if s >= self.threshold:
            engine.fire(self, observed=s, threshold=self.threshold,
                        message=f"{s:.0f} {self.series} events in "
                                f"{self.window_s:.0f}s (threshold "
                                f"{self.threshold:.0f})")
        else:
            engine.clear(self)


class RecompileDetector(Detector):
    """Steady-state recompile: an observatory event whose cause is not
    warmup/first_call AFTER the process has run `grace_steps` steps.
    STICKY — a recompiling steady state is a misconfiguration (mis-sized
    bucket ladder, mutating program) that won't heal on its own.

    Counts via the CUMULATIVE `executor_recompiles_total` metric, not
    the observatory's bounded event ring — ring eviction on a busy
    server would silently deflate a ring-length baseline and blind the
    detector (steplog.counts() documents exactly this hazard)."""

    name = "steady_state_recompile"
    series = None

    def __init__(self, grace_steps: int = 20):
        self.grace_steps = grace_steps
        self._baseline: Optional[float] = None

    @staticmethod
    def _unexpected_total() -> float:
        from .steplog import EXPECTED_CAUSES
        c = _metrics.default_registry().get("executor_recompiles_total")
        total = 0.0
        if c is not None:
            for labels, v in c.items():
                if labels.get("cause") not in EXPECTED_CAUSES:
                    total += v
        return total

    def check(self, engine, now):
        if engine.active_alert(self.name) is not None:
            return  # sticky
        from . import steplog as _steplog
        steps = _steplog.get_steplog().phase_summary()["steps"]
        total = self._unexpected_total()
        if self._baseline is None or steps <= self.grace_steps \
                or total < self._baseline:
            # warmup era — or the FIRST check of a health plane armed
            # mid-run (pre-pulse recompiles must not trip a permanent
            # sticky alert) — or a registry reset zeroed the counter:
            # re-baseline; only growth from here on is steady-state
            self._baseline = total
            return
        if total > self._baseline:
            unexpected = _steplog.observatory().unexpected()
            ev = unexpected[-1] if unexpected else None
            engine.fire(self, observed=ev.cause if ev else "unknown",
                        threshold=f"none after step {self.grace_steps}",
                        message=f"steady-state recompile: cause="
                                f"{ev.cause if ev else '?'} source="
                                f"{ev.source if ev else '?'} after "
                                f"{steps} steps "
                                f"({total - self._baseline:.0f} new)")

    def acknowledge(self, engine):
        # remediated: the counted recompiles become history; only NEW
        # growth fires again
        self._baseline = self._unexpected_total()


# ONE definition of "saturated" for the whole plane: the detector and
# the InferenceServer's registered /readyz check both read this, so the
# two verdicts in one /healthz body can never use divergent thresholds
SERVE_QUEUE_SATURATION_FRAC = 0.9

# ONE definition of "nearly exhausted" shared by the detector and any
# serving-side check, mirroring SERVE_QUEUE_SATURATION_FRAC's contract
KV_CACHE_EXHAUSTION_FRAC = 0.9


class CapacityRatioDetector(Detector):
    """Shared shape of every used-vs-capacity rule: a pair of gauges
    with matching label sets; fire when ANY label's used >= frac *
    capacity, clear when none is. `message_fmt` may reference {model},
    {used}, {cap} and {frac}."""

    series = None

    def __init__(self, name: str, used_metric: str, capacity_metric: str,
                 frac: float, message_fmt: str):
        self.name = name
        self.used_metric = used_metric
        self.capacity_metric = capacity_metric
        self.frac = frac
        self.message_fmt = message_fmt

    def check(self, engine, now):
        reg = _metrics.default_registry()
        used = reg.get(self.used_metric)
        cap = reg.get(self.capacity_metric)
        if used is None or cap is None:
            engine.clear(self)
            return
        caps = {tuple(sorted(labels.items())): v for labels, v in cap.items()}
        for labels, u in used.items():
            c = caps.get(tuple(sorted(labels.items())))
            if c and u >= self.frac * c:
                engine.fire(self, observed=u, threshold=self.frac * c,
                            message=self.message_fmt.format(
                                model=labels.get("model", "?"), used=u,
                                cap=c, frac=self.frac))
                return
        engine.clear(self)


class QueueSaturationDetector(CapacityRatioDetector):
    """serve_queue_depth at or above `frac` of serve_queue_capacity for
    any model label (both gauges are set by the MicroBatcher)."""

    def __init__(self, frac: float = SERVE_QUEUE_SATURATION_FRAC):
        super().__init__(
            "serve_queue_saturation", "serve_queue_depth",
            "serve_queue_capacity", frac,
            "serve queue {model} at {used:.0f}/{cap:.0f} (>= {frac:.0%})")


class KvCacheExhaustionDetector(CapacityRatioDetector):
    """fluid-decode: paged-KV occupancy (allocated + admission-reserved
    blocks, i.e. exactly what the admission check sees) at or above
    `frac` of capacity for any (model, version) label. Fires BEFORE
    admissions start failing with CacheExhaustedError — the
    router/operator signal to shed generative load or grow the cache.
    Self-clears as finished sequences free their blocks."""

    def __init__(self, frac: float = KV_CACHE_EXHAUSTION_FRAC):
        super().__init__(
            "kv_cache_exhaustion", "serve_kv_blocks_in_use",
            "serve_kv_blocks_capacity", frac,
            "KV cache {model} at {used:.0f}/{cap:.0f} blocks "
            "(>= {frac:.0%}) — generative admissions about to stall")


class ReplicationStallDetector(Detector):
    """fluid-haven: the primary's replication lag
    (`ps_replication_lag_updates` gauge, fed from the ack watermark)
    grew MONOTONICALLY across the window while pushes kept being served
    — the backup is alive enough to hold the connection but not keeping
    up, so the failover loss bound is eroding toward the full window.
    Idle lag (no pushes) never fires: a paused trainer is not a stall.
    Self-clears as soon as the watermark catches up (lag dips)."""

    name = "ps_replication_stall"
    series = "ps_replication_lag"

    def __init__(self, window_s: float = 20.0, min_points: int = 4):
        self.window_s = window_s
        self.min_points = min_points

    def check(self, engine, now):
        pts = [(ts, v) for ts, v in engine.series(self.series).points()
               if ts > now - self.window_s]
        if len(pts) < self.min_points:
            engine.clear(self)
            return
        vals = [v for _ts, v in pts]
        growing = all(b >= a for a, b in zip(vals, vals[1:])) \
            and vals[-1] > vals[0] and vals[-1] > 0
        pushes, _n = engine.series("ps_push_serves").window_sum(
            self.window_s, now=now)
        if growing and pushes > 0:
            engine.fire(self, observed=vals[-1], threshold=vals[0],
                        message=f"replication lag grew {vals[0]:.0f} -> "
                                f"{vals[-1]:.0f} updates over "
                                f"{self.window_s:.0f}s while "
                                f"{pushes:.0f} pushes landed — backup "
                                f"not keeping up")
        else:
            engine.clear(self)


class QuorumLossDetector(Detector):
    """fluid-quorum: any resource whose `quorum_lease_ok` gauge sits at
    0 — the holder believes it owns the lease but its renew rounds
    cannot reach a strict majority of arbiters. While this fires the
    holder's write path is fenced; if it persists to local expiry the
    holder steps down. Self-clears the moment a renew or a fresh grant
    lands (the client writes the gauge back to 1)."""

    name = "quorum_loss"
    series = "quorum_lease_ok"

    def check(self, engine, now):
        reg = _metrics.default_registry()
        g = reg.get("quorum_lease_ok")
        if g is None:
            engine.clear(self)
            return
        for labels, v in g.items():
            if v == 0.0:
                engine.fire(
                    self, observed=0.0, threshold=1.0,
                    message=f"quorum lease "
                            f"{labels.get('resource', '?')!r} cannot "
                            f"renew against a majority — holder fenced, "
                            f"step-down at local expiry",
                    detail=dict(labels))
                return
        engine.clear(self)


class TaskStarvationDetector(Detector):
    """fluid-elastic: the data master holds outstanding work (todo +
    pending gauges > 0) but NO task has been issued or finished for a
    window — trainers stopped pulling (all dead? all wedged on a fenced
    master?) or the master stopped issuing. Requires the progress
    series to have EVER moved, so a freshly loaded dataset whose
    trainers simply haven't started yet never fires. Self-clears on the
    next issue/finish."""

    name = "task_starvation"
    series = "master_task_progress"

    def __init__(self, window_s: float = 15.0):
        self.window_s = window_s

    def check(self, engine, now):
        reg = _metrics.default_registry()
        outstanding = 0.0
        for metric in ("master_tasks_todo", "master_tasks_pending"):
            g = reg.get(metric)
            if g is not None:
                outstanding += sum(v for _l, v in g.items())
        ts = engine.series(self.series)
        if outstanding <= 0 or len(ts) == 0:
            engine.clear(self)
            return
        s, _n = ts.window_sum(self.window_s, now=now)
        if s == 0:
            engine.fire(self, observed=outstanding, threshold=0,
                        message=f"{outstanding:.0f} tasks outstanding but "
                                f"no issue/finish progress in "
                                f"{self.window_s:.0f}s — the data plane "
                                f"is starved")
        else:
            engine.clear(self)


class TaskDiscardDetector(Detector):
    """fluid-elastic: a task burned its failure budget and was DISCARDED
    — every record it carried is silently lost for this pass (today's
    quiet data-loss mode, reference processFailedTask :323). STICKY:
    lost data does not come back; after remediation (re-run the pass)
    an operator clears it with `engine.clear_alerts()`. Discards that
    pre-date the health plane arming are baselined, not alerted."""

    name = "task_discard"
    series = "master_task_discards"

    def __init__(self):
        self._baseline: Optional[float] = None

    def check(self, engine, now):
        if engine.active_alert(self.name) is not None:
            return  # sticky
        c = _metrics.default_registry().get("master_tasks_discarded_total")
        total = c.total() if c is not None else 0.0
        if self._baseline is None or total < self._baseline:
            # first check of a plane armed mid-run, or a registry reset
            self._baseline = total
            return
        if total > self._baseline:
            engine.fire(self, observed=total,
                        threshold=self._baseline,
                        message=f"{total - self._baseline:.0f} task(s) "
                                f"discarded after burning their failure "
                                f"budget — their records are LOST for "
                                f"this pass")

    def acknowledge(self, engine):
        c = _metrics.default_registry().get("master_tasks_discarded_total")
        self._baseline = c.total() if c is not None else 0.0


class CompressionCollapseDetector(Detector):
    """fluid-wire ratio collapse: the windowed raw/on-wire byte ratio
    fell to half of the best ratio this session established. A session
    that never compressed (raw mode, ratio ~1) never fires."""

    name = "wire_compression_collapse"
    series = "wire_encoded_bytes"

    def __init__(self, window_s: float = 30.0, min_bytes: float = 4096.0,
                 established: float = 1.5, collapse_frac: float = 0.5):
        self.window_s = window_s
        self.min_bytes = min_bytes
        self.established = established
        self.collapse_frac = collapse_frac
        self._best = 0.0

    def check(self, engine, now):
        raw, _ = engine.series("wire_raw_bytes").window_sum(self.window_s,
                                                            now=now)
        enc, _ = engine.series("wire_encoded_bytes").window_sum(
            self.window_s, now=now)
        if enc < self.min_bytes or raw <= 0:
            engine.clear(self)
            return
        ratio = raw / enc
        self._best = max(self._best, ratio)
        if self._best >= self.established and \
                ratio < self.collapse_frac * self._best:
            engine.fire(self, observed=round(ratio, 2),
                        threshold=round(self.collapse_frac * self._best, 2),
                        message=f"wire compression fell to {ratio:.2f}x "
                                f"(session best {self._best:.2f}x) — "
                                f"quantization silently degraded?")
        else:
            engine.clear(self)


# default metric -> series plumbing: which registry writes feed which ring
DEFAULT_WATCHES = (
    # (metric name, series name, label filter or None)
    ("trainer_last_loss", "train_loss", None),
    ("trainer_grad_norm", "grad_norm", None),
    ("executor_steps_total", "steps", None),
    ("pserver_client_retries_total", "ps_retries", None),
    ("pserver_trainers_evicted_total", "lease_churn", None),
    ("pserver_trainers_readmitted_total", "lease_churn", None),
    ("serve_rejects_total", "serve_deadline_miss", {"reason": "deadline"}),
    ("pserver_wire_bytes_raw", "wire_raw_bytes", None),
    ("pserver_wire_bytes_encoded", "wire_encoded_bytes", None),
    # fluid-fleet: router-side failovers (a replica answered a request
    # another replica dropped) — a storm means replicas are flapping
    ("fleet_failovers_total", "fleet_failovers", None),
    # fluid-haven: replication lag levels (gauge) + the push traffic
    # that distinguishes a stalling backup from an idle trainer — one
    # spec per push command (the watch filter is exact-match)
    ("ps_replication_lag_updates", "ps_replication_lag", None),
    ("pserver_server_requests_total", "ps_push_serves",
     {"cmd": "push_grad"}),
    ("pserver_server_requests_total", "ps_push_serves",
     {"cmd": "push_grads"}),
    ("pserver_server_requests_total", "ps_push_serves",
     {"cmd": "push_grads_sync"}),
    ("pserver_server_requests_total", "ps_push_serves",
     {"cmd": "push_sparse_grad"}),
    # fluid-quorum: renew verdicts (1 ok / 0 failing while held) — the
    # quorum_loss detector's evidence series for alert postmortems
    ("quorum_lease_ok", "quorum_lease_ok", None),
    # fluid-elastic: master task-lifecycle progress (issues + finishes
    # both count — either proves the data plane is moving) and the
    # discard stream the task_discard detector baselines against
    ("master_tasks_issued_total", "master_task_progress", None),
    ("master_tasks_finished_total", "master_task_progress", None),
    ("master_tasks_discarded_total", "master_task_discards", None),
)


class HealthEngine:
    """Series store + detector set + external checks -> one verdict."""

    def __init__(self):
        self._lock = threading.RLock()
        self._series: Dict[str, TimeSeries] = {}
        self._detectors: Dict[str, Detector] = {}
        self._active: Dict[str, Alert] = {}
        self._history: deque = deque(maxlen=128)
        self._checks: Dict[str, Tuple[Callable, bool]] = {}
        # each spec is [metric, series, label_filter, armed_generation]:
        # a sink is (re-)registered only when the spec's armed generation
        # differs from the registry's — arming exactly once per
        # generation, so a spec can never double-feed its ring (a doubled
        # series would fire windowed detectors at half their threshold)
        self._watch_specs: List[list] = []
        # (metric, sink) pairs currently registered with the registry, so
        # reset() can DETACH them — an orphaned sink would keep feeding a
        # dead ring on every metric write
        self._armed_sinks: List[Tuple[str, Callable]] = []
        self._defaults_installed = False

    # -- series -----------------------------------------------------------

    def series(self, name: str) -> TimeSeries:
        with self._lock:
            ts = self._series.get(name)
            if ts is None:
                ts = self._series[name] = TimeSeries()
            return ts

    def feed(self, name: str, value: float, ts: Optional[float] = None):
        """Direct append (callers that hold a value but no metric)."""
        self.series(name).append(value, ts=ts)

    def watch_metric(self, metric: str, series: Optional[str] = None,
                     label_filter: Optional[dict] = None):
        """Feed `series` from every write of registry metric `metric`
        (optionally only writes whose labels match `label_filter`).
        Survives registry resets: the watch re-arms on the next
        evaluate()."""
        with self._lock:
            self._watch_specs.append([metric, series or metric,
                                      label_filter, None])
        self._ensure_watches()

    def _arm(self, spec):
        metric, series_name, label_filter, _ = spec
        ring = self.series(series_name)

        def sink(value, label_key):
            if label_filter:
                d = dict(label_key)
                for lk, lv in label_filter.items():
                    if d.get(lk) != str(lv):
                        return
            ring.append(value)

        # stamp the generation the sink was actually registered INTO
        # (returned under the registry lock): a reset racing this arm
        # either clears the sink (stamp stays stale -> re-armed next
        # check) or post-dates it (stamp is current) — never two live
        # sinks for one spec
        spec[3] = _metrics.default_registry().watch(metric, sink)
        self._armed_sinks.append((metric, sink))

    def _ensure_watches(self):
        gen = _metrics.default_registry().generation()
        with self._lock:
            for spec in self._watch_specs:
                if spec[3] != gen:
                    self._arm(spec)

    # -- detectors / checks ----------------------------------------------

    def add_detector(self, det: Detector):
        with self._lock:
            self._detectors[det.name] = det

    def install_default_detectors(self):
        """The built-in catalog + its metric->series plumbing. Idempotent
        — start_pulse() calls this so a bare `observe.start_pulse()` is a
        fully armed health plane."""
        with self._lock:
            if self._defaults_installed:
                return
            self._defaults_installed = True
            specs = [s for s in DEFAULT_WATCHES
                     if not any(w[0] == s[0] and w[1] == s[1]
                                for w in self._watch_specs)]
            for metric, series_name, label_filter in specs:
                self._watch_specs.append([metric, series_name,
                                          label_filter, None])
        for det in (NonFiniteDetector(),
                    # a poisoned PARAMETER shows up as a non-finite
                    # gradient norm on the next step — this is the
                    # "non-finite param" leg of the catalog
                    NonFiniteDetector(name="non_finite_grad",
                                      series="grad_norm"),
                    SpikeDetector(),
                    RateCollapseDetector(),
                    RecompileDetector(),
                    QueueSaturationDetector(),
                    KvCacheExhaustionDetector(),
                    RateSpikeDetector("ps_retry_storm", "ps_retries",
                                      window_s=15.0, threshold=8.0),
                    RateSpikeDetector("lease_churn", "lease_churn",
                                      window_s=60.0, threshold=3.0),
                    RateSpikeDetector("serve_deadline_miss",
                                      "serve_deadline_miss",
                                      window_s=15.0, threshold=8.0),
                    # fluid-fleet: sustained request rerouting — one
                    # failover per dead replica is the design working;
                    # a windowed burst means membership is flapping or a
                    # replica is half-dead (accepting then dropping)
                    RateSpikeDetector("fleet_failover_storm",
                                      "fleet_failovers",
                                      window_s=15.0, threshold=8.0),
                    ReplicationStallDetector(),
                    QuorumLossDetector(),
                    TaskStarvationDetector(),
                    TaskDiscardDetector(),
                    CompressionCollapseDetector()):
            self.add_detector(det)
        self._ensure_watches()   # arms only the not-yet-armed specs

    def register_check(self, name: str, fn: Callable, ready: bool = True):
        """External component check: `fn() -> (ok, detail_dict)`.
        `ready=True` checks also gate /readyz (the fluid-fleet router's
        take-traffic signal)."""
        with self._lock:
            self._checks[name] = (fn, ready)

    def unregister_check(self, name: str):
        with self._lock:
            self._checks.pop(name, None)

    # -- evaluation -------------------------------------------------------

    def evaluate(self, now: Optional[float] = None) -> List[Alert]:
        """Run every detector once; returns the active alerts."""
        self._ensure_watches()
        now = time.time() if now is None else now
        with self._lock:
            dets = list(self._detectors.values())
        for det in dets:
            try:
                det.check(self, now)
            except Exception:
                pass  # one broken rule must not take down the verdict
        with self._lock:
            return list(self._active.values())

    def fire(self, det: Detector, observed, threshold, message: str,
             detail: Optional[dict] = None):
        """ok -> firing transition: record once; re-fires while already
        active only refresh the observed value."""
        with self._lock:
            existing = self._active.get(det.name)
            if existing is not None:
                existing.observed = observed
                return
            alert = Alert(det.name, det.series or det.name, observed,
                          threshold, message, detail)
            self._active[det.name] = alert
            self._history.append(alert)
        _metrics.counter(
            ALERTS_METRIC, "health detector alerts fired").inc(
                rule=det.name)
        # flight recorder: the alert AND the last points of the
        # triggering series, so the postmortem shows why health went red
        points = []
        if det.series is not None:
            points = [(round(ts, 3), v)
                      for ts, v in self.series(det.series).points(16)]
        _flight.note("alert", rule=det.name, metric=alert.metric,
                     threshold=threshold, observed=observed,
                     message=message, points=points)

    def clear(self, det: Detector):
        with self._lock:
            alert = self._active.pop(det.name, None)
        if alert is not None:
            _flight.note("alert_clear", rule=det.name)

    def active_alert(self, rule: str) -> Optional[Alert]:
        with self._lock:
            return self._active.get(rule)

    def active_alerts(self) -> List[Alert]:
        with self._lock:
            return list(self._active.values())

    def history(self) -> List[Alert]:
        with self._lock:
            return list(self._history)

    # -- verdict (the /healthz /readyz JSON) ------------------------------

    def verdict(self, ready_only: bool = False) -> dict:
        """The health-plane contract (docs/OBSERVABILITY.md §fluid-pulse):
        ``status`` is "ok" or "unready"; every check contributes
        ``{ok, detail}``; active alerts ride along in full."""
        import os

        from . import xray as _xray

        alerts = self.evaluate()
        checks: Dict[str, dict] = {}
        with self._lock:
            ext = dict(self._checks)
            dets = list(self._detectors.values())
        for name, (fn, ready) in ext.items():
            if ready_only and not ready:
                continue
            try:
                ok, detail = fn()
            except Exception as e:
                ok, detail = False, {"error": f"{type(e).__name__}: {e}"}
            checks[name] = {"ok": bool(ok), "detail": detail}
        checks["detectors"] = {
            "ok": not alerts,
            "detail": {d.name: d.state(self) for d in dets}}
        ok_all = all(c["ok"] for c in checks.values())
        return {
            "status": "ok" if ok_all else "unready",
            "ts": time.time(),
            "pid": os.getpid(),
            "process": _xray.process_name(),
            "checks": checks,
            "alerts": [a.as_dict() for a in alerts],
        }

    def clear_alerts(self):
        """Operator path for clearing STICKY alerts (non-finite,
        steady-state recompile) after remediation — wiring stays intact,
        unlike reset(). Each cleared rule's detector is acknowledged so
        the SAME old evidence (the NaN still on the ring, the already-
        counted recompiles) cannot re-fire it on the next evaluate;
        fresh evidence fires a fresh alert."""
        with self._lock:
            rules = list(self._active)
            dets = dict(self._detectors)
            self._active.clear()
        for rule in rules:
            det = dets.get(rule)
            if det is not None:
                try:
                    det.acknowledge(self)
                except Exception:
                    pass

    def reset(self):
        with self._lock:
            # detach armed sinks: registry watches would otherwise keep
            # feeding orphaned rings on every write (and accumulate one
            # closure per reset/install cycle)
            reg = _metrics.default_registry()
            for metric, sink in self._armed_sinks:
                reg.unwatch(metric, sink)
            self._armed_sinks.clear()
            self._series.clear()
            self._detectors.clear()
            self._active.clear()
            self._history.clear()
            self._checks.clear()
            self._watch_specs.clear()
            self._defaults_installed = False


_engine = HealthEngine()


def get_engine() -> HealthEngine:
    return _engine


def note_loss_fetch(outs) -> None:
    """Land a fetched loss on the health plane: sets the
    `trainer_last_loss` gauge (the emit path DEFAULT_WATCHES mirrors
    into the `train_loss` series the non-finite detector scans). ONE
    definition shared by Trainer and the PS trainers — the detector
    keys on this exact metric name. Caller gates on the observe flag.

    `outs` is the step's user fetch list. By fluid convention the loss
    is fetch[0] and that value feeds the series — but a NON-FINITE
    scalar anywhere in the fetches overrides it, so a caller who
    ordered fetch_list=[acc, loss] still trips the non-finite detector
    when the loss goes NaN (any poisoned training scalar is the signal,
    whatever its slot)."""
    import math

    import numpy as np
    if not isinstance(outs, (list, tuple)):
        outs = [outs]
    val = None
    for i, o in enumerate(outs):
        v = np.asarray(o)
        if v.size != 1:
            continue
        f = float(v.reshape(-1)[0])
        if val is None and i == 0:
            val = f
        if not math.isfinite(f):
            val = f
            break
    if val is not None:
        _metrics.gauge("trainer_last_loss",
                       "most recent training loss (fetch[0]; any "
                       "non-finite scalar fetch overrides)").set(val)


def feed(name: str, value: float, ts: Optional[float] = None):
    _engine.feed(name, value, ts=ts)


def reset():
    """Clear the engine. If a pulse server is LIVE, the default
    detectors re-install immediately — a running health plane must not
    be left evaluating zero rules (it would answer a trivial 200 ok for
    the rest of the process lifetime). To clear sticky alerts after
    remediation, prefer `get_engine().clear_alerts()`."""
    _engine.reset()
    from . import pulse as _pulse   # lazy: pulse imports health
    if _pulse.get_pulse() is not None:
        _engine.install_default_detectors()

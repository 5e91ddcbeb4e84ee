"""fluid-horizon observatory: one scraper, one store, one pane of glass.

Every fleet process exposes a pulse `/metrics` endpoint, but each is a
POINT-IN-TIME view of ONE process: "what is the fleet's QPS" or "is any
pserver's replication lag growing" requires polling N endpoints over
time and joining the answers. This module is that join:

- `Scraper` polls every registered target's `/metrics` on an interval
  (one daemon thread, stdlib urllib — a dead target scores `up=0` and
  never stalls the loop past its timeout) and ingests the samples into
- `TimeSeriesStore` — a bounded in-memory store of labeled series
  (per-sample deques; every point carries the scrape wall-time), with
  the three query shapes a control loop needs:

      rate(name, window_s)          counter increase/sec, reset-aware,
                                    summed across matching series
      latest(name, agg=...)         newest gauge value per series
                                    (sum/max/min across, or the list)
      percentile(name, q, window_s) histogram_quantile over the
                                    windowed increase of the _bucket
                                    series — the classic Prometheus
                                    estimator, cross-instance
      mean(name, window_s)          windowed Δ_sum/Δ_count of a
                                    histogram (e.g. decode occupancy)

- `fleet_overview()` derives the fleet-level series ROADMAP's
  fluid-tide controller needs — total QPS, max replication lag, decode
  occupancy, request p99 — from whatever targets are being scraped.

Labels: every ingested sample gains `job` (the target's role name) and
`instance` (host:port) so per-process series never collide and queries
can filter either way. The store is bounded in BOTH axes (points per
series, series count) — a scraper left running for a week cannot grow
host memory past its budget.

Copy of ``paddle_tpu/observe/scrape.py``, its imports rewired to this
package.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
from collections import deque
from typing import Dict, List, Optional, Tuple

from . import metrics as _metrics

DEFAULT_POINTS = 600        # per series: 10 min of 1 s scrapes
DEFAULT_MAX_SERIES = 8192

#: synthetic per-target liveness series (1 scraped ok, 0 failed)
UP_SERIES = "horizon_up"


def _label_key(labels: Dict[str, str]) -> Tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _matches(labels: Dict[str, str], match: Optional[Dict[str, str]]) -> bool:
    if not match:
        return True
    return all(labels.get(k) == str(v) for k, v in match.items())


class TimeSeriesStore:
    """Bounded labeled time series: (name, labels) -> deque[(ts, value)].

    Writers are scrape threads, readers are CLI/controller threads; every
    access to the two maps below holds `_lock` (appends and queries are
    O(points) at worst — never network- or disk-bound), so the store
    needs no finer discipline.
    """

    def __init__(self, max_points: int = DEFAULT_POINTS,
                 max_series: int = DEFAULT_MAX_SERIES):
        self.max_points = int(max_points)
        self.max_series = int(max_series)
        self._lock = threading.Lock()
        # series data: (name, label_key) -> deque[(ts, value)]
        self._series: Dict[Tuple, deque] = {}   # guarded_by: self._lock
        # (name, label_key) -> labels dict (for query results)
        self._labels: Dict[Tuple, Dict[str, str]] = {}  # guarded_by: self._lock
        self._dropped = 0                       # guarded_by: self._lock

    def add(self, name: str, labels: Dict[str, str], value: float,
            ts: Optional[float] = None):
        key = (name, _label_key(labels))
        ts = time.time() if ts is None else ts
        with self._lock:
            dq = self._series.get(key)
            if dq is None:
                if len(self._series) >= self.max_series:
                    self._dropped += 1   # bounded: new series are shed
                    return
                dq = self._series[key] = deque(maxlen=self.max_points)
                self._labels[key] = dict(labels)
            dq.append((ts, float(value)))

    # -- introspection -----------------------------------------------------

    def names(self) -> List[str]:
        with self._lock:
            return sorted({name for name, _ in self._series})

    def series(self, name: str, match: Optional[dict] = None
               ) -> List[Tuple[Dict[str, str], List[Tuple[float, float]]]]:
        """[(labels, [(ts, value), ...]), ...] for every matching series."""
        with self._lock:
            out = []
            for (n, lk), dq in self._series.items():
                if n != name:
                    continue
                labels = self._labels[(n, lk)]
                if _matches(labels, match):
                    out.append((dict(labels), list(dq)))
        return out

    def dropped_series(self) -> int:
        with self._lock:
            return self._dropped

    def __len__(self):
        with self._lock:
            return len(self._series)

    # -- queries -----------------------------------------------------------

    def latest(self, name: str, match: Optional[dict] = None,
               agg: Optional[str] = None):
        """Newest value per matching series. `agg` folds across series
        ("sum"/"max"/"min"; None -> [(labels, value), ...]). Aggregates
        over zero series return None — "no data" must not read as 0."""
        rows = [(labels, pts[-1][1])
                for labels, pts in self.series(name, match) if pts]
        if agg is None:
            return rows
        if not rows:
            return None
        vals = [v for _, v in rows]
        return {"sum": sum, "max": max, "min": min}[agg](vals)

    def _windowed(self, pts: List[Tuple[float, float]], now: float,
                  window_s: float) -> List[Tuple[float, float]]:
        """Points inside the window plus the last point BEFORE it (the
        baseline a counter delta needs — without it the first in-window
        increase is invisible)."""
        lo = now - window_s
        inside = [p for p in pts if p[0] >= lo]
        before = [p for p in pts if p[0] < lo]
        return ([before[-1]] if before else []) + inside

    def increase(self, name: str, window_s: float = 30.0,
                 match: Optional[dict] = None,
                 now: Optional[float] = None) -> float:
        """Counter increase over the window, summed across matching
        series. Reset-aware: a decrease (process restart) contributes
        the post-reset value, never a negative delta."""
        now = time.time() if now is None else now
        total = 0.0
        for _, pts in self.series(name, match):
            win = self._windowed(pts, now, window_s)
            for (t0, v0), (t1, v1) in zip(win, win[1:]):
                total += (v1 - v0) if v1 >= v0 else v1
        return total

    def rate(self, name: str, window_s: float = 30.0,
             match: Optional[dict] = None,
             now: Optional[float] = None) -> float:
        """increase()/sec over the ACTUAL observed span (clamped to the
        window) — a store holding 3 s of data asked for a 30 s rate
        divides by 3, not 30."""
        now = time.time() if now is None else now
        spans = []
        for _, pts in self.series(name, match):
            win = self._windowed(pts, now, window_s)
            if len(win) >= 2:
                spans.append(win[-1][0] - win[0][0])
        if not spans:
            return 0.0
        elapsed = min(max(spans), window_s)
        if elapsed <= 0:
            return 0.0
        return self.increase(name, window_s, match, now=now) / elapsed

    def mean(self, name: str, window_s: float = 60.0,
             match: Optional[dict] = None) -> Optional[float]:
        """Windowed mean of a histogram: Δ`name_sum` / Δ`name_count`
        across matching series (None when no events landed)."""
        now = time.time()
        dc = self.increase(f"{name}_count", window_s, match, now=now)
        if dc <= 0:
            return None
        return self.increase(f"{name}_sum", window_s, match, now=now) / dc

    def percentile(self, name: str, q: float, window_s: float = 60.0,
                   match: Optional[dict] = None) -> Optional[float]:
        """histogram_quantile over the windowed increase of the
        `{name}_bucket` series, merged across instances: per `le`
        boundary sum the increase, walk the cumulative counts to the
        q-rank, interpolate linearly inside the landing bucket. None
        when no events landed in the window."""
        now = time.time()
        by_le: Dict[float, float] = {}
        for labels, pts in self.series(f"{name}_bucket", match):
            le_raw = labels.get("le")
            if le_raw is None:
                continue
            le = float("inf") if le_raw == "+Inf" else float(le_raw)
            win = self._windowed(pts, now, window_s)
            inc = 0.0
            for (t0, v0), (t1, v1) in zip(win, win[1:]):
                inc += (v1 - v0) if v1 >= v0 else v1
            by_le[le] = by_le.get(le, 0.0) + inc
        if not by_le:
            return None
        bounds = sorted(by_le)
        total = by_le.get(float("inf"), 0.0) or max(by_le.values())
        if total <= 0:
            return None
        target = q * total
        cum = 0.0
        prev_bound, prev_cum = 0.0, 0.0
        for le in bounds:
            cum = by_le[le]   # buckets are CUMULATIVE per exposition spec
            if cum >= target and cum > prev_cum:
                hi = le if le != float("inf") else prev_bound
                frac = (target - prev_cum) / (cum - prev_cum)
                return prev_bound + (hi - prev_bound) * frac
            prev_bound = le if le != float("inf") else prev_bound
            prev_cum = max(prev_cum, cum)
        return prev_bound


class Scraper:
    """Polls every target's pulse `/metrics` into one TimeSeriesStore.

    Thread shape: ONE poll-loop daemon thread (`horizon-scrape`), started
    by `start()` and stopped via `_stop` (a threading.Event — the only
    cross-thread signal). The target list may be edited while the loop
    runs; it is copied under `_lock` per round.
    """

    def __init__(self, targets=None, interval_s: float = 1.0,
                 timeout_s: float = 2.0,
                 store: Optional[TimeSeriesStore] = None):
        self.store = store or TimeSeriesStore()
        self.interval_s = float(interval_s)
        self.timeout_s = float(timeout_s)
        self._lock = threading.Lock()
        self._targets: List[Dict[str, str]] = []   # guarded_by: self._lock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._rounds = 0                           # guarded_by: self._lock
        for t in (targets or []):
            if isinstance(t, dict):
                self.add_target(t["job"], t["url"])
            else:
                job, url = t
                self.add_target(job, url)

    @staticmethod
    def _normalize_url(url) -> str:
        if isinstance(url, int):
            return f"http://127.0.0.1:{url}"
        url = str(url)
        if url.isdigit():        # bare port from a CLI arg
            return f"http://127.0.0.1:{url}"
        if "://" not in url:
            url = f"http://{url}"
        return url.rstrip("/")

    def add_target(self, job: str, url) -> str:
        """Register one pulse endpoint (`url` may be a full URL, a
        host:port, or a bare local port). Returns the normalized URL;
        duplicate registrations are idempotent."""
        url = self._normalize_url(url)
        with self._lock:
            if not any(t["url"] == url for t in self._targets):
                self._targets.append({"job": str(job), "url": url})
        return url

    def remove_target(self, url):
        url = self._normalize_url(url)
        with self._lock:
            self._targets = [t for t in self._targets if t["url"] != url]

    def targets(self) -> List[Dict[str, str]]:
        with self._lock:
            return [dict(t) for t in self._targets]

    # -- scraping ----------------------------------------------------------

    def _fetch(self, url: str) -> str:
        with urllib.request.urlopen(f"{url}/metrics",
                                    timeout=self.timeout_s) as resp:
            return resp.read().decode("utf-8", "replace")

    def poll_once(self) -> Dict[str, dict]:
        """One synchronous scrape round over every target. Returns
        per-url {"ok", "families", "error"}; a failing target is
        recorded as `horizon_up 0` and never raises."""
        results: Dict[str, dict] = {}
        ts = time.time()
        for t in self.targets():
            job, url = t["job"], t["url"]
            instance = url.split("://", 1)[-1]
            base = {"job": job, "instance": instance}
            try:
                families = _metrics.parse_prometheus_text(self._fetch(url))
                for fam in families.values():
                    for sname, labels, value in fam["samples"]:
                        self.store.add(sname, dict(labels, **base),
                                       value, ts=ts)
                self.store.add(UP_SERIES, base, 1.0, ts=ts)
                results[url] = {"ok": True, "families": len(families),
                                "error": None}
            except Exception as e:
                self.store.add(UP_SERIES, base, 0.0, ts=ts)
                results[url] = {"ok": False, "families": 0,
                                "error": f"{type(e).__name__}: {e}"}
        with self._lock:
            self._rounds += 1
        return results

    def rounds(self) -> int:
        with self._lock:
            return self._rounds

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.poll_once()
            except Exception:
                pass   # the plane outlives any one bad round

    def start(self) -> "Scraper":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="horizon-scrape")
            self._thread.start()
        return self

    def stop(self, timeout: float = 5.0):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None

    # -- derived fleet series ---------------------------------------------

    def fleet_overview(self, window_s: float = 30.0) -> dict:
        """The fleet-level derived series — what `tools/observatory.py
        --watch` tabulates and the fluid-tide controller will read.
        Every value is None (not 0) when no data supports it."""
        s = self.store
        up = s.latest(UP_SERIES)
        return {
            "targets": len(self.targets()),
            "targets_up": sum(1 for _, v in up if v >= 1.0) if up else 0,
            # replica-side accepted work (summed over models/outcomes)
            "serve_qps": s.rate("serve_requests_total", window_s),
            # router-side routed work (includes sheds/failovers)
            "fleet_qps": s.rate("fleet_requests_total", window_s),
            "request_p50_us": s.percentile("serve_request_latency_us",
                                           0.50, window_s),
            "request_p99_us": s.percentile("serve_request_latency_us",
                                           0.99, window_s),
            "max_ps_replication_lag": s.latest(
                "ps_replication_lag_updates", agg="max"),
            "decode_occupancy": s.mean("serve_decode_occupancy", window_s),
            "ps_rpc_qps": s.rate("pserver_client_requests_total", window_s),
            "master_tasks_todo": s.latest("master_tasks_todo", agg="sum"),
        }

    def snapshot(self, window_s: float = 30.0) -> dict:
        """One JSON-able document: targets, derived overview, and the
        newest value of every stored series (`tools/observatory.py
        --json`)."""
        latest = {}
        for name in self.store.names():
            latest[name] = [
                {"labels": labels, "value": value}
                for labels, value in self.store.latest(name) or []]
        return {"ts": time.time(), "targets": self.targets(),
                "overview": self.fleet_overview(window_s),
                "series": latest,
                "store": {"series": len(self.store),
                          "dropped_series": self.store.dropped_series()}}


def fetch_trace(url, timeout_s: float = 5.0) -> dict:
    """GET a pulse `/trace` endpoint: the target's live tracer ring as a
    chrome-trace document (what `tools/observatory.py --dump-trace`
    stitches across the fleet)."""
    url = Scraper._normalize_url(url)
    with urllib.request.urlopen(f"{url}/trace", timeout=timeout_s) as resp:
        return json.loads(resp.read().decode("utf-8", "replace"))

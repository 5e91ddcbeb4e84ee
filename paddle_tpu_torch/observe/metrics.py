"""Process-wide metrics registry: counters / gauges / histograms.

Reference analog: the profiler event tables of platform/profiler.cc gave
Fluid aggregate counts; TensorFlow's whitepaper credits built-in metrics
plumbing for making large-scale training debuggable. Here the registry is
a plain thread-safe in-process store — no exporter daemon, no deps — with
`snapshot()` (dict), `to_json()` and `to_prometheus()` (text exposition
format) so a training loop or a serving process can dump it at any point.
Copy of ``paddle_tpu/observe/metrics.py``.

All three metric kinds support labels passed as keyword arguments:

    counter("pserver_client_requests_total").inc(cmd="push_grad")
    histogram("executor_step_phase_us").observe(12.5, phase="feed_convert")

Writers are cheap (one lock + dict update) but NOT free: runtime emitters
gate on the `observe` flag so the prepared-executor hot path stays clean
when telemetry is off.
"""

from __future__ import annotations

import bisect
import json
import math
import re
import threading
from typing import Any, Dict, List, Optional, Tuple

# wide geometric default buckets: usable for µs phase timings and for
# second-scale RPC latencies alike (callers pick the unit, the buckets
# span 1e-6 .. 1e6)
DEFAULT_BUCKETS = (1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 0.1, 1.0, 10.0, 100.0,
                   1e3, 1e4, 1e5, 1e6)


def _label_key(labels: Dict[str, Any]) -> Tuple:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _label_str(key: Tuple) -> str:
    return ",".join(f"{k}={v}" for k, v in key)


def _prom_escape(v: str) -> str:
    """Label-VALUE escaping per the exposition spec: backslash first (or
    the other escapes would double-escape), then double-quote and
    newline. A label value containing any of the three can no longer
    corrupt a scrape — pinned by the strict round-trip test."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _prom_escape_help(v: str) -> str:
    """HELP-text escaping: the spec escapes backslash and line feed only
    (a double-quote is legal in help text)."""
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


def _prom_value(v) -> str:
    """Sample-value formatting: Python would print `inf`/`nan`, which the
    exposition grammar rejects — Prometheus spells them `+Inf`/`-Inf`/
    `NaN`."""
    try:
        f = float(v)
    except (TypeError, ValueError):
        return str(v)
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if math.isnan(f):
        return "NaN"
    return repr(f) if isinstance(v, float) else str(v)


def _prom_labels(key: Tuple, extra: str = "") -> str:
    parts = [f'{k}="{_prom_escape(v)}"' for k, v in key]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._values: Dict[Tuple, Any] = {}
        # write-path hooks (observe.health rides these to feed bounded
        # TimeSeries rings): a tuple so the unwatched hot path pays one
        # attribute load + falsy test, nothing else
        self._watchers: Tuple = ()

    def clear(self):
        with self._lock:
            self._values.clear()

    def labelsets(self):
        with self._lock:
            return list(self._values)

    def items(self):
        """[(labels_dict, value)] over every label set. For histograms
        the value is the internal bucket state — use summary() there."""
        with self._lock:
            return [(dict(k), v) for k, v in self._values.items()]

    # scalar (counter/gauge) serialization; Histogram overrides both
    def _snapshot(self):
        with self._lock:
            return {_label_str(k): v for k, v in self._values.items()}

    def _prometheus(self, lines):
        with self._lock:
            for k, v in sorted(self._values.items()):
                lines.append(f"{self.name}{_prom_labels(k)} {_prom_value(v)}")

    def _notify(self, v, k):
        # called OUTSIDE the value lock: a watcher appending to its own
        # ring must not be able to deadlock against a concurrent writer
        for w in self._watchers:
            try:
                w(v, k)
            except Exception:
                pass


class Counter(_Metric):
    kind = "counter"

    def inc(self, n: float = 1, **labels):
        k = _label_key(labels)
        with self._lock:
            self._values[k] = self._values.get(k, 0) + n
        if self._watchers:
            self._notify(n, k)   # watchers see the INCREMENT (rates)

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(_label_key(labels), 0)

    def total(self) -> float:
        """Sum over every label set."""
        with self._lock:
            return sum(self._values.values())


class Gauge(_Metric):
    kind = "gauge"

    def set(self, v: float, **labels):
        k = _label_key(labels)
        with self._lock:
            self._values[k] = v
        if self._watchers:
            self._notify(v, k)

    def inc(self, n: float = 1, **labels):
        k = _label_key(labels)
        with self._lock:
            v = self._values[k] = self._values.get(k, 0) + n
        if self._watchers:
            self._notify(v, k)   # watchers see the new LEVEL

    def dec(self, n: float = 1, **labels):
        self.inc(-n, **labels)

    def value(self, **labels) -> Optional[float]:
        with self._lock:
            return self._values.get(_label_key(labels))


class Histogram(_Metric):
    """Fixed-bucket histogram. Per label set it keeps cumulative bucket
    counts plus sum/count/min/max, so `summary()` can report a mean and
    envelope without storing samples."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "", buckets=DEFAULT_BUCKETS):
        super().__init__(name, help)
        self.buckets = tuple(sorted(buckets))

    def observe(self, v: float, **labels):
        k = _label_key(labels)
        with self._lock:
            st = self._values.get(k)
            if st is None:
                st = self._values[k] = {
                    "buckets": [0] * (len(self.buckets) + 1),
                    "sum": 0.0, "count": 0,
                    "min": float("inf"), "max": float("-inf")}
            st["buckets"][bisect.bisect_left(self.buckets, v)] += 1
            st["sum"] += v
            st["count"] += 1
            st["min"] = min(st["min"], v)
            st["max"] = max(st["max"], v)
        if self._watchers:
            self._notify(v, k)   # watchers see the raw SAMPLE

    def summary(self, **labels) -> Optional[dict]:
        with self._lock:
            st = self._values.get(_label_key(labels))
            if st is None:
                return None
            return {"count": st["count"], "sum": st["sum"],
                    "mean": st["sum"] / max(st["count"], 1),
                    "min": st["min"], "max": st["max"]}

    QUANTILES = (0.5, 0.9, 0.99)

    def _estimate_quantiles(self, st, qs=QUANTILES) -> Dict[float, float]:
        """Bucket-interpolated quantile estimates (the classic Prometheus
        histogram_quantile): walk the cumulative bucket counts to the
        target rank, interpolate linearly inside the landing bucket, and
        clamp to the observed [min, max] envelope (which also makes a
        single-sample histogram report that sample exactly)."""
        counts = st["buckets"]
        total = st["count"]
        out: Dict[float, float] = {}
        if total <= 0:
            return out
        for q in qs:
            target = q * total
            cum = 0.0
            v = st["max"]
            for i, n in enumerate(counts):
                cum += n
                if cum >= target and n > 0:
                    lo = self.buckets[i - 1] if i > 0 else min(
                        st["min"], self.buckets[0])
                    hi = self.buckets[i] if i < len(self.buckets) \
                        else st["max"]
                    frac = (target - (cum - n)) / n
                    v = lo + (hi - lo) * frac
                    break
            out[q] = min(max(v, st["min"]), st["max"])
        return out

    def quantiles(self, qs=QUANTILES, **labels) -> Optional[Dict[float, float]]:
        with self._lock:
            st = self._values.get(_label_key(labels))
            if st is None:
                return None
            return self._estimate_quantiles(st, qs)

    def _snapshot(self):
        with self._lock:
            out = {}
            for k, st in self._values.items():
                out[_label_str(k)] = {
                    "count": st["count"], "sum": round(st["sum"], 9),
                    "mean": round(st["sum"] / max(st["count"], 1), 9),
                    "min": st["min"], "max": st["max"]}
            return out

    def _prometheus(self, lines):
        qlines = []
        with self._lock:
            for k, st in sorted(self._values.items()):
                cum = 0
                for ub, n in zip(self.buckets, st["buckets"]):
                    cum += n
                    le = 'le="%s"' % ub
                    lines.append(f"{self.name}_bucket"
                                 f"{_prom_labels(k, le)} {cum}")
                cum += st["buckets"][-1]
                inf = 'le="+Inf"'
                lines.append(f"{self.name}_bucket"
                             f"{_prom_labels(k, inf)} {cum}")
                lines.append(f"{self.name}_sum{_prom_labels(k)} "
                             f"{_prom_value(st['sum'])}")
                lines.append(f"{self.name}_count{_prom_labels(k)} "
                             f"{st['count']}")
                for q, v in sorted(self._estimate_quantiles(st).items()):
                    ql = f'quantile="{q}"'
                    qlines.append(f"{self.name}_quantile"
                                  f"{_prom_labels(k, ql)} "
                                  f"{_prom_value(float(f'{v:.9g}'))}")
        # estimated p50/p90/p99 as a SEPARATE `<name>_quantile` gauge
        # family: dashboards get latency percentiles without a
        # histogram_quantile() recording rule, and strict scrapers stay
        # happy (quantile samples on the bare name are only legal under
        # TYPE summary)
        if qlines:
            lines.append(f"# TYPE {self.name}_quantile gauge")
            lines.extend(qlines)


class Registry:
    """Name -> metric store. `counter`/`gauge`/`histogram` are
    get-or-create; asking for an existing name with a different kind is a
    programming error and raises."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}
        # name -> [watch fns]: attached to the metric object at creation,
        # so a watch installed BEFORE the metric first emits still sees
        # every write (observe.health arms its detectors this way)
        self._watches: Dict[str, list] = {}
        # bumped on reset() so holders of cached metric handles (e.g. the
        # steplog's hot path) can detect that their handle was orphaned
        self._generation = 0

    def generation(self) -> int:
        return self._generation

    def _get_or_create(self, cls, name, help, **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, **kw)
                if name in self._watches:
                    m._watchers = tuple(self._watches[name])
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {cls.kind}")
            return m

    def watch(self, name: str, fn) -> int:
        """Mirror every write of metric `name` into `fn(value, label_key)`
        — counters pass the increment, gauges the new level, histograms
        the raw sample. O(1) on the write path; metrics created later
        pick the watch up at creation. Cleared by reset(). Returns the
        generation the watch was registered INTO (read under the same
        lock reset() takes), so a re-arming caller can stamp exactly
        which generation its sink lives in — no TOCTOU against a
        concurrent reset."""
        with self._lock:
            fns = self._watches.setdefault(name, [])
            fns.append(fn)
            m = self._metrics.get(name)
            if m is not None:
                m._watchers = tuple(fns)
            return self._generation

    def unwatch(self, name: str, fn) -> None:
        """Detach one watch fn (health-engine reset: orphaned sinks must
        not keep feeding dead rings on the hot write path)."""
        with self._lock:
            fns = self._watches.get(name)
            if not fns or fn not in fns:
                return
            fns.remove(fn)
            if not fns:
                self._watches.pop(name)
            m = self._metrics.get(name)
            if m is not None:
                m._watchers = tuple(fns)

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def names(self):
        with self._lock:
            return sorted(self._metrics)

    def snapshot(self) -> Dict[str, dict]:
        """JSON-safe dict: name -> {kind, help, values: {labelstr: v}}."""
        with self._lock:
            metrics = list(self._metrics.values())
        return {m.name: {"kind": m.kind, "help": m.help,
                         "values": m._snapshot()} for m in metrics}

    def to_json(self, indent=None) -> str:
        return json.dumps(self.snapshot(), indent=indent, sort_keys=True)

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (scrape-compatible)."""
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        lines = []
        for m in metrics:
            if m.help:
                lines.append(f"# HELP {m.name} {_prom_escape_help(m.help)}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            m._prometheus(lines)
        return "\n".join(lines) + ("\n" if lines else "")

    def reset(self):
        """Drop every metric (definitions AND watches)."""
        with self._lock:
            self._metrics.clear()
            self._watches.clear()
            self._generation += 1


_registry = Registry()


def default_registry() -> Registry:
    return _registry


def counter(name: str, help: str = "") -> Counter:
    return _registry.counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:
    return _registry.gauge(name, help)


def histogram(name: str, help: str = "", buckets=DEFAULT_BUCKETS) -> Histogram:
    return _registry.histogram(name, help, buckets=buckets)


# ---------------------------------------------------------------------------
# strict exposition-format parser (fluid-pulse)
# ---------------------------------------------------------------------------
# The round-trip pin for to_prometheus(): every line a scrape produces
# must match the text-exposition grammar EXACTLY, and label values
# containing `\`, `"` or a newline must come back byte-identical. Also
# what tests/pulse use to prove a live /metrics scrape is well-formed.

_METRIC_NAME_RE = r"[a-zA-Z_:][a-zA-Z0-9_:]*"
_LABEL_PAIR_RE = (r'[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\\n]|\\\\|\\"|\\n)*"')
_VALUE_RE = (r"[+-]?(?:[0-9]+(?:\.[0-9]*)?|\.[0-9]+)(?:[eE][+-]?[0-9]+)?"
             r"|[+-]?Inf|NaN")
_SAMPLE_RE = re.compile(
    rf"^(?P<name>{_METRIC_NAME_RE})"
    rf"(?:\{{(?P<labels>{_LABEL_PAIR_RE}(?:,{_LABEL_PAIR_RE})*)?\}})?"
    rf" (?P<value>{_VALUE_RE})$")
_LABEL_RE = re.compile(
    r'(?P<k>[a-zA-Z_][a-zA-Z0-9_]*)="(?P<v>(?:[^"\\\n]|\\\\|\\"|\\n)*)"'
    r"(?:,|$)")
_HELP_RE = re.compile(rf"^# HELP (?P<name>{_METRIC_NAME_RE}) (?P<help>.*)$")
_TYPE_RE = re.compile(
    rf"^# TYPE (?P<name>{_METRIC_NAME_RE}) "
    r"(?P<kind>counter|gauge|histogram|summary|untyped)$")


def _unescape(v: str, what: str, quote_ok: bool) -> str:
    """Left-to-right escape scan — sequential str.replace would corrupt
    e.g. an escaped backslash followed by a literal `n` (`\\\\n` must
    become backslash+n, not a newline)."""
    out, i = [], 0
    while i < len(v):
        c = v[i]
        if c == "\\" and i + 1 < len(v):
            nxt = v[i + 1]
            if nxt == "\\":
                out.append("\\")
            elif nxt == '"' and quote_ok:
                out.append('"')
            elif nxt == "n":
                out.append("\n")
            else:
                raise ValueError(f"illegal escape \\{nxt} in {what}")
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _unescape_label(v: str) -> str:
    return _unescape(v, "label value", quote_ok=True)


def _parse_value(s: str) -> float:
    if s in ("+Inf", "Inf"):
        return float("inf")
    if s == "-Inf":
        return float("-inf")
    if s == "NaN":
        return float("nan")
    return float(s)


def parse_prometheus_text(text: str) -> Dict[str, dict]:
    """STRICT line-grammar parse of a text-exposition document.

    Returns ``{family: {"kind", "help", "samples": [(name, labels, value),
    ...]}}`` where `labels` is a dict with values UN-escaped. Raises
    ``ValueError`` naming the first malformed line — this is the
    round-trip gate, not a lenient scraper."""
    out: Dict[str, dict] = {}

    def family(name: str) -> dict:
        base = name
        for suf in ("_bucket", "_count", "_sum"):
            if base.endswith(suf) and base[: -len(suf)] in out:
                base = base[: -len(suf)]
                break
        return out.setdefault(base, {"kind": None, "help": None,
                                     "samples": []})

    for lineno, line in enumerate(text.splitlines(), 1):
        if not line:
            continue
        if line.startswith("#"):
            m = _HELP_RE.match(line)
            if m:
                # reverse of _prom_escape_help (\\ and \n only — a raw
                # quote in help text is legal and never escaped)
                family(m.group("name"))["help"] = _unescape(
                    m.group("help"), "help text", quote_ok=False)
                continue
            m = _TYPE_RE.match(line)
            if m:
                family(m.group("name"))["kind"] = m.group("kind")
                continue
            raise ValueError(f"line {lineno}: malformed comment: {line!r}")
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"line {lineno}: malformed sample: {line!r}")
        labels: Dict[str, str] = {}
        raw = m.group("labels")
        if raw:
            consumed = 0
            for lm in _LABEL_RE.finditer(raw):
                if lm.start() != consumed:
                    raise ValueError(
                        f"line {lineno}: malformed labels: {raw!r}")
                labels[lm.group("k")] = _unescape_label(lm.group("v"))
                consumed = lm.end()
            if consumed != len(raw):
                raise ValueError(f"line {lineno}: malformed labels: {raw!r}")
        try:
            value = _parse_value(m.group("value"))
        except ValueError:
            raise ValueError(
                f"line {lineno}: malformed value: {m.group('value')!r}")
        family(m.group("name"))["samples"].append(
            (m.group("name"), labels, value))
    return out

"""The device-memory observatory.

Copy of ``paddle_tpu/observe/memory.py`` with its device probe rewritten
over ``torch.cuda``. An OOM death otherwise leaves a log tail and no
account of WHO held the bytes. This module keeps a per-process ledger of
per-program peak-memory *estimates*
(analysis.cost_model.estimate_peak_hbm over the concrete shapes each
program actually bound) and compares them against LIVE device memory
stats whenever a card is visible.

Live stats, per visible card i, under the JAX package's key names:

- ``bytes_in_use``       ``torch.cuda.memory_stats(i)["allocated_bytes.all.current"]``
- ``peak_bytes_in_use``  ``...["allocated_bytes.all.peak"]`` (what
                         ``torch.cuda.max_memory_allocated(i)`` reads)
- ``pool_bytes``         ``...["reserved_bytes.all.current"]`` (the
                         caching allocator's reserve)
- ``bytes_limit``        the card's total memory, ``torch.cuda.mem_get_info(i)[1]``

``largest_free_block_bytes`` has no counterpart and is left out, as the
JAX package leaves out a key its backend lacks.

Degradation contract: with no card visible (the CPU every test of this
repo runs on) the observatory is estimate-only — silently, never a
warning per call and never an error. The observatory must be safe to
consult from a signal handler (the flight recorder dumps a memory
section on OOM/SIGTERM), so every public entry point swallows backend
exceptions.

Estimates are recorded when the executor builds a step plan (never hot,
and only while the `observe` flag is on); the pulse `/status` endpoint
renders `report()`. The estimate sums every tensor of a step, where the
port's executor frees nothing before the step ends and the caching
allocator adds workspace on top: read it against the live peak, do not
gate on their ratio.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

# the JAX package's live-stat name -> torch.cuda.memory_stats' key
# (`bytes_limit` comes from torch.cuda.mem_get_info)
_LIVE_STAT_KEYS = {"bytes_in_use": "allocated_bytes.all.current",
                   "peak_bytes_in_use": "allocated_bytes.all.peak",
                   "pool_bytes": "reserved_bytes.all.current"}


class MemoryObservatory:
    def __init__(self, capacity: int = 256):
        self._lock = threading.Lock()
        # key -> {"name", "source", "ts", estimate fields...}
        self._programs: Dict[str, dict] = {}
        self._capacity = capacity
        self._segment_peak = 0.0
        self._live_probed = False
        self._live_available = False
        # last successful probe, served by flight_section(): a crash
        # dump must never talk to a (possibly wedged) backend
        self._last_live: Optional[List[dict]] = None

    # -- estimates --------------------------------------------------------

    def note_program(self, program, feed_arrays: Dict, source: str =
                     "executor", name: Optional[str] = None) -> Optional[dict]:
        """Record the peak device-memory estimate of `program` bound with
        the concrete `feed_arrays` shapes. Called when the executor
        builds a step plan (the shape walk costs milliseconds); one
        entry per (program, feed-shape signature). Never raises."""
        try:
            feed_shapes = {n: tuple(getattr(v, "shape", ()))
                           for n, v in feed_arrays.items()}
            key = (f"{name or 'prog'}#{getattr(program, '_uid', 0)}@"
                   + ",".join(f"{n}:{'x'.join(map(str, s))}"
                              for n, s in sorted(feed_shapes.items())))
            with self._lock:
                if key in self._programs:
                    return self._programs[key]
            from ..analysis import cost_model as _cm
            est = _cm.estimate_peak_hbm(program, feed_shapes)
            rec = dict(est, name=name or f"prog{getattr(program, '_uid', 0)}",
                       source=source, ts=time.time())
            with self._lock:
                if len(self._programs) >= self._capacity:
                    # drop the oldest entry — a long-lived server loading
                    # many model versions must not grow unboundedly
                    oldest = min(self._programs,
                                 key=lambda k: self._programs[k]["ts"])
                    self._programs.pop(oldest)
                self._programs[key] = rec
                self._segment_peak = max(self._segment_peak,
                                         rec["peak_bytes"])
            return rec
        except Exception:
            return None

    def programs(self) -> Dict[str, dict]:
        with self._lock:
            return dict(self._programs)

    def estimate_peak_bytes(self) -> float:
        """The largest single-program peak estimate currently tracked —
        programs don't all run at once, so the max (not the sum) is the
        honest single-number estimate."""
        with self._lock:
            return max((r["peak_bytes"] for r in self._programs.values()),
                       default=0.0)

    def segment_peak(self, reset: bool = False) -> float:
        """Max peak estimate recorded since the last reset (read per
        measured segment)."""
        with self._lock:
            v = self._segment_peak
            if reset:
                self._segment_peak = 0.0
            return v

    # -- live device stats ------------------------------------------------

    def live_device_stats(self) -> Optional[List[dict]]:
        """Per-card memory stats from ``torch.cuda``, or None when no
        card is visible (CPU) — the estimate-only degradation. No
        warnings either way; `live_available()` says which mode we are
        in."""
        try:
            import torch
            n = torch.cuda.device_count() if torch.cuda.is_available() \
                else 0
        except Exception:
            n = 0
        out = []
        for i in range(n):
            try:
                st = torch.cuda.memory_stats(i)
                total = int(torch.cuda.mem_get_info(i)[1])
            except Exception:
                continue
            rec = {"device": f"cuda:{i}", "platform": "gpu"}
            for key, src in _LIVE_STAT_KEYS.items():
                if src in st:
                    rec[key] = int(st[src])
            rec["bytes_limit"] = total
            out.append(rec)
        self._live_probed = True
        self._live_available = bool(out)
        if out:
            self._last_live = out
        return out or None

    def live_available(self) -> bool:
        if not self._live_probed:
            self.live_device_stats()
        return self._live_available

    # -- reports ----------------------------------------------------------

    def report(self) -> dict:
        """The memory section of /status, telemetry dumps, and the flight
        recorder: tracked per-program estimates, the honest aggregate,
        and — when a real backend exists — live bytes with a
        proportional-share attribution across the tracked programs."""
        progs = self.programs()
        live = self.live_device_stats()
        est_total = sum(r["peak_bytes"] for r in progs.values())
        doc: dict = {
            "live": live is not None,
            "estimate_peak_bytes": self.estimate_peak_bytes(),
            "programs": {
                k: {f: r[f] for f in
                    ("name", "source", "param_bytes",
                     "optimizer_slot_bytes", "grad_bytes",
                     "activation_bytes", "feed_bytes", "peak_bytes")}
                for k, r in progs.items()},
        }
        if live is not None:
            doc["devices"] = live
            in_use = sum(d.get("bytes_in_use", 0) for d in live)
            doc["bytes_in_use"] = in_use
            doc["peak_bytes_in_use"] = sum(
                d.get("peak_bytes_in_use", 0) for d in live)
            if est_total > 0 and in_use > 0:
                # attribution heuristic, clearly labeled: live bytes
                # split across tracked programs proportionally to their
                # estimates (the caching allocator keeps no per-program accounting)
                for r in doc["programs"].values():
                    r["attributed_live_bytes"] = int(
                        in_use * (r["peak_bytes"] / est_total))
        return doc

    def flight_section(self) -> dict:
        """Compact variant for the flight recorder (a dump must stay
        readable): aggregate numbers + the top-4 programs by estimate.
        Runs inside signal handlers — serves the LAST-KNOWN device
        stats and never probes the backend (a wedged/OOMing runtime
        could hang the dying process mid-dump)."""
        progs = sorted(self.programs().values(),
                       key=lambda r: -r["peak_bytes"])[:4]
        sec = {"estimate_peak_bytes": self.estimate_peak_bytes(),
               "programs": [{"name": r["name"], "source": r["source"],
                             "peak_bytes": r["peak_bytes"],
                             "param_bytes": r["param_bytes"]}
                            for r in progs]}
        if self._last_live is not None:
            sec["devices"] = self._last_live
            sec["devices_as_of"] = ("last-probe cache; crash dumps never "
                                    "touch the backend")
        return sec

    def clear(self):
        with self._lock:
            self._programs.clear()
            self._segment_peak = 0.0
            # drop the live-probe cache too: after a reset_all a later
            # flight dump must not attribute PRE-reset device bytes, and
            # live_available() must re-probe rather than answer stale
            self._last_live = None
            self._live_probed = False
            self._live_available = False


_observatory = MemoryObservatory()


def get_observatory() -> MemoryObservatory:
    return _observatory


def note_program(program, feed_arrays, source="executor", name=None):
    return _observatory.note_program(program, feed_arrays, source=source,
                                     name=name)


def report() -> dict:
    return _observatory.report()


def reset():
    _observatory.clear()

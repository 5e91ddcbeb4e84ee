"""Crash flight recorder: a bounded black box that survives the crash.

Chaos drills deliberately kill processes, and a benchmark run that
overshoots its budget is SIGTERMed — and without a recorder both leave
only a log tail. The flight recorder keeps a bounded ring of the
most recent *operationally interesting* records — step summaries, RPC
outcomes, compile events, lease transitions, chaos injections — plus a
named "stage", and dumps the whole thing as JSON when the process dies
abnormally (SIGTERM, unhandled exception, or an explicit `dump()` from
a crash path such as bench.py's wakeup-fd watcher).

Recording is an O(1) deque append under a lock; emitters gate on the
`observe` flag exactly like the metrics registry where the path is hot
(per-step records), and record unconditionally where it is not
(compiles, lease transitions — events measured in seconds, recorded in
microseconds).

The dump is plain JSON, newest-last, with enough identity (pid, process
name, stage, reason) that a postmortem can be read standalone:

    {"pid": ..., "process": "trainer0", "reason": "SIGTERM", ...,
     "failure_stage": "transformer2048_unfused",
     "events": [{"ts": ..., "kind": "step", ...}, ...]}

Copy of ``paddle_tpu/observe/flight.py``, its imports rewired to this
package.
"""

from __future__ import annotations

import json
import os
import signal as _signal
import sys
import threading
import time
import traceback
import math
from collections import deque
from typing import Callable, List, Optional

DEFAULT_CAPACITY = 512

#: env override for where an UNINSTALLED recorder dumps (drills that
#: never call install() used to litter `flight_recorder.json` into the
#: CWD — i.e. the repo root when run from a checkout)
DUMP_PATH_ENV = "PADDLE_TPU_FLIGHT_PATH"


def default_dump_path() -> str:
    """The dump path when neither dump(path=...) nor install(path=...)
    named one: `$PADDLE_TPU_FLIGHT_PATH` if set, else a pid-suffixed
    file under the system temp dir — NEVER the current directory."""
    env = os.environ.get(DUMP_PATH_ENV)
    if env:
        return env
    import tempfile
    return os.path.join(tempfile.gettempdir(),
                        f"flight_recorder.{os.getpid()}.json")


def json_safe(v):
    """RFC 8259 has no NaN/Infinity but Python's json emits bare `NaN`
    tokens — a postmortem (or /healthz body) carrying a non-finite
    observed value must still parse in strict readers. Stringify
    non-finite floats recursively."""
    if isinstance(v, float) and not math.isfinite(v):
        return repr(v)          # 'nan' / 'inf' / '-inf', as a string
    if isinstance(v, dict):
        return {k: json_safe(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [json_safe(x) for x in v]
    return v


class FlightRecorder:
    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self._events: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._stage: Optional[str] = None
        self._dump_path: Optional[str] = None
        self._extra_dump: Optional[Callable] = None
        self._installed = False
        self._prev_excepthook = None
        self._dumped = threading.Event()
        # named snapshot providers merged into every dump (fluid-pulse
        # registers "memory" here so an OOM/SIGTERM death carries the
        # HBM observatory). Providers survive clear() — they are wiring,
        # not state.
        self._sections: dict = {}

    def add_section(self, name: str, fn: Callable):
        """Merge `fn()` into every snapshot under `name`, best-effort (a
        failing provider is dropped from that dump, never raises)."""
        self._sections[name] = fn

    # -- recording --------------------------------------------------------

    def note(self, kind: str, **data):
        """Append one record. Cheap (deque append) but not free — hot
        paths gate on the `observe` flag before calling."""
        ev = {"ts": time.time(), "kind": kind}
        ev.update(data)
        with self._lock:
            self._events.append(ev)

    def set_stage(self, stage: Optional[str]):
        """Name the phase the process is in (bench segment, drill
        scenario, epoch...) — dumped as `failure_stage`."""
        self._stage = stage

    def stage(self) -> Optional[str]:
        return self._stage

    def events(self, kind: Optional[str] = None) -> List[dict]:
        with self._lock:
            evs = list(self._events)
        if kind is not None:
            evs = [e for e in evs if e["kind"] == kind]
        return evs

    def clear(self):
        with self._lock:
            self._events.clear()
        self._stage = None

    def __len__(self):
        with self._lock:
            return len(self._events)

    # -- dumping ----------------------------------------------------------

    def snapshot(self, reason: Optional[str] = None) -> dict:
        from . import xray as _xray
        with self._lock:
            evs = list(self._events)
        doc = {
            "pid": os.getpid(),
            "process": _xray.process_name(),
            "dumped_at": time.time(),
            "reason": reason,
            "failure_stage": self._stage,
            "events": evs,
        }
        for name, fn in list(self._sections.items()):
            try:
                doc[name] = fn()
            except Exception:
                pass
        return doc

    def dump(self, path: Optional[str] = None,
             reason: Optional[str] = None) -> Optional[str]:
        """Write the black box as JSON. `path` defaults to the installed
        path (install()), then `$PADDLE_TPU_FLIGHT_PATH`, then a
        pid-suffixed file under the system temp dir — never the CWD (a
        drill run from a checkout must not litter the repo root). Never
        raises — a failing postmortem writer must not mask the original
        crash; returns the path written or None."""
        path = path or self._dump_path or default_dump_path()
        try:
            snap = json_safe(self.snapshot(reason=reason))
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(snap, f, indent=1, default=str)
            os.replace(tmp, path)  # a torn dump never shadows a good one
            self._dumped.set()
            return path
        except Exception:
            return None

    # -- crash hooks ------------------------------------------------------

    def install(self, path: str, signals=(getattr(_signal, "SIGTERM", None),),
                excepthook: bool = True,
                extra: Optional[Callable] = None):
        """Arm the black box: dump to `path` on the given signals and on
        unhandled exceptions. `extra` (e.g. a tracer chrome export) runs
        after the dump, best-effort. Signal handlers hard-exit (code 1)
        after dumping — the process was being killed anyway, and a
        half-torn-down runtime should not keep running.

        Only usable from the main thread (CPython signal rule); bench.py
        keeps its own wakeup-fd watcher and just calls `dump()`."""
        self._dump_path = path
        self._extra_dump = extra
        if not self._installed and excepthook:
            self._prev_excepthook = sys.excepthook

            def _hook(exc_type, exc, tb):
                self.note("unhandled_exception",
                          error=f"{exc_type.__name__}: {exc}",
                          traceback="".join(
                              traceback.format_tb(tb))[-2000:])
                self.dump(reason=f"unhandled {exc_type.__name__}")
                self._run_extra()
                (self._prev_excepthook or sys.__excepthook__)(
                    exc_type, exc, tb)

            sys.excepthook = _hook
        for sig in signals:
            if sig is None:
                continue

            def _on_signal(signum, frame, _self=self):
                _self.note("signal", signum=int(signum))
                _self.dump(reason=f"signal {int(signum)}")
                _self._run_extra()
                os._exit(1)

            _signal.signal(sig, _on_signal)
        self._installed = True

    def _run_extra(self):
        if self._extra_dump is not None:
            try:
                self._extra_dump()
            except Exception:
                pass


_recorder = FlightRecorder()


def get_flight() -> FlightRecorder:
    return _recorder


def note(kind: str, **data):
    _recorder.note(kind, **data)


def set_stage(stage: Optional[str]):
    _recorder.set_stage(stage)


def dump(path: Optional[str] = None, reason: Optional[str] = None):
    return _recorder.dump(path=path, reason=reason)


def install(path: str, **kw):
    _recorder.install(path, **kw)

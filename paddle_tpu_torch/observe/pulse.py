"""fluid-pulse: the per-process HTTP observability endpoint.

Every process of the fleet (trainer, pserver, serving replica, bench)
can expose one stdlib-HTTP thread serving its live telemetry:

    GET /metrics    Prometheus text exposition (the registry's
                    to_prometheus(), strict-grammar clean)
    GET /healthz    liveness + health verdict: per-check detail +
                    active detector alerts; 200 when ok, 503 when
                    unready. The contract fluid-fleet's router polls.
    GET /readyz     readiness subset (ready-flagged checks + detectors)
    GET /status     full JSON snapshot: metrics, step phases, recompile
                    observatory, memory observatory, health, alerts —
                    the same shape tools/telemetry_dump.py prints, so
                    one tool reads dead and live processes
    GET /flight     the flight-recorder ring as JSON, live
    GET /trace      the tracer ring as a chrome-trace document — what
                    tools/observatory.py --dump-trace stitches across
                    a live fleet (fluid-horizon)

Opt-in and flag-gated:

    fluid.set_flag("observe", True)
    port = observe.start_pulse(port=0)     # 0 = ephemeral, returns bound

With the `observe` flag off, `start_pulse` is REFUSED (RuntimeError):
a health plane over a registry that is contractually empty would lie
with 200s. The server is one daemon thread (ThreadingHTTPServer, so
concurrent scrapes don't serialize), binds 127.0.0.1 by default, and
shuts down cleanly via `stop_pulse()` — which `observe.reset_all()`
calls, so tier-1 tests can never leak the thread.

A lightweight ticker re-evaluates the health engine every
`tick_s` seconds even when nobody scrapes, so alerts still land in the
flight recorder ring of a process that dies unobserved.

Copy of ``paddle_tpu/observe/pulse.py``, its imports rewired to this
package.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .. import flags as _flags
from . import flight as _flight
from . import health as _health
from . import memory as _memory
from . import metrics as _metrics
from .flight import json_safe as _json_safe


def status_document() -> dict:
    """The /status body — also what `tools/telemetry_dump.py` prints for
    the in-process path, keeping dead- and live-process reads shape-
    identical."""
    import os
    import time

    from . import steplog as _steplog
    from . import xray as _xray

    return {
        "pid": os.getpid(),
        "process": _xray.process_name(),
        "ts": time.time(),
        "metrics": _metrics.default_registry().snapshot(),
        "steps": _steplog.get_steplog().phase_summary(),
        "recompiles": {
            "counts": _steplog.observatory().counts(),
            "events": [e.as_dict() for e in _steplog.observatory().events()],
        },
        "memory": _memory.report(),
        # evaluate, don't just read: /status is a pull-evaluation point
        # like /healthz, so both bodies agree even with the ticker off
        "alerts": [a.as_dict()
                   for a in _health.get_engine().evaluate()],
    }


class _PulseHandler(BaseHTTPRequestHandler):
    server_version = "fluid-pulse/1"
    protocol_version = "HTTP/1.1"

    def log_message(self, *args):   # a scrape must never spam stderr
        pass

    def _send(self, code: int, body: bytes, ctype: str):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, doc: dict):
        self._send(code, json.dumps(_json_safe(doc), default=str).encode(),
                   "application/json")

    def do_GET(self):
        path = self.path.split("?", 1)[0].rstrip("/") or "/"
        try:
            if path == "/metrics":
                body = _metrics.default_registry().to_prometheus().encode()
                self._send(200, body,
                           "text/plain; version=0.0.4; charset=utf-8")
            elif path in ("/healthz", "/readyz"):
                doc = _health.get_engine().verdict(
                    ready_only=(path == "/readyz"))
                self._send_json(200 if doc["status"] == "ok" else 503, doc)
            elif path == "/status":
                self._send_json(200, status_document())
            elif path == "/flight":
                self._send_json(
                    200, _flight.get_flight().snapshot(reason="live"))
            elif path == "/trace":
                from . import tracer as _tracer
                self._send_json(200, {
                    "traceEvents": _tracer.get_tracer().chrome_events(),
                    "displayTimeUnit": "ms"})
            elif path == "/":
                self._send_json(200, {
                    "service": "fluid-pulse",
                    "endpoints": ["/metrics", "/healthz", "/readyz",
                                  "/status", "/flight", "/trace"]})
            else:
                self._send_json(404, {"error": f"no route {path!r}"})
        except Exception as e:   # a broken section must not kill the plane
            try:
                self._send_json(500,
                                {"error": f"{type(e).__name__}: {e}"})
            except Exception:
                pass


class PulseServer:
    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 tick_s: float = 1.0):
        self._httpd = ThreadingHTTPServer((host, port), _PulseHandler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = int(self._httpd.server_address[1])
        self._tick_s = float(tick_s)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name=f"pulse@{self.port}")
        self._ticker = threading.Thread(
            target=self._tick_loop, daemon=True,
            name=f"pulse-tick@{self.port}")

    def start(self) -> "PulseServer":
        self._thread.start()
        if self._tick_s > 0:
            self._ticker.start()
        return self

    def _tick_loop(self):
        engine = _health.get_engine()
        while not self._stop.wait(self._tick_s):
            try:
                engine.evaluate()
            except Exception:
                pass

    def stop(self, timeout: float = 5.0):
        self._stop.set()
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except Exception:
            pass
        self._thread.join(timeout=timeout)
        if self._ticker.is_alive():
            self._ticker.join(timeout=timeout)

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"


_lock = threading.Lock()
_pulse: Optional[PulseServer] = None


def start_pulse(port: int = 0, host: str = "127.0.0.1",
                tick_s: float = 1.0) -> int:
    """Start this process's pulse endpoint (idempotent — a second call
    returns the already-bound port) and arm the default health
    detectors. Returns the bound port. REFUSED while the `observe` flag
    is off."""
    global _pulse
    if not _flags.get_flag("observe"):
        raise RuntimeError(
            "observe.start_pulse() requires the observe flag: call "
            "fluid.set_flag('observe', True) (or set PADDLE_TPU_OBSERVE=1) "
            "first — a health plane over a disabled registry would "
            "report healthy no matter what")
    with _lock:
        if _pulse is not None:
            return _pulse.port
        _health.get_engine().install_default_detectors()
        _pulse = PulseServer(port=port, host=host, tick_s=tick_s).start()
        return _pulse.port


def stop_pulse(timeout: float = 5.0):
    """Shut the endpoint down (idempotent). observe.reset_all() calls
    this, so a test that started a pulse cannot leak its thread."""
    global _pulse
    with _lock:
        p, _pulse = _pulse, None
    if p is not None:
        p.stop(timeout=timeout)


def get_pulse() -> Optional[PulseServer]:
    return _pulse

"""Observability: runtime telemetry for paddle_tpu_torch.

The surface of ``paddle_tpu/observe/``, copied module by module with the
imports rewired (``memory``'s device probe is rewritten over
``torch.cuda``):

- `observe.metrics`  — process-wide registry of counters / gauges /
  histograms (thread-safe, labeled, snapshot/JSON/Prometheus export)
- `observe.tracer`   — structured spans in a bounded ring buffer with
  chrome://tracing export and the multi-process merge
- `observe.steplog`  — per-run() StepStats phase timings + the plan-build
  observatory (every new step plan, with attributed cause)
- `observe.xray`     — W3C trace contexts across processes
- `observe.flight`   — the crash flight recorder
- `observe.pulse`    — per-process HTTP health endpoint: /metrics,
  /healthz, /readyz, /status, /flight, /trace (`start_pulse(port=0)`)
- `observe.health`   — metric time-series + anomaly detectors firing
  structured Alerts into the registry AND the flight ring
- `observe.memory`   — the device-memory observatory: per-program peak
  estimates vs live ``torch.cuda`` memory stats
- `observe.stitch`   — causal cross-process trace assembly: flow
  events + clock-skew correction over merged chrome traces
- `observe.scrape`   — a scraper over every pulse /metrics into one
  queryable time-series store

Emission from hot paths (PreparedProgram / ParallelExecutor steps,
AsyncFeeder, the serving path's spans) is gated on the `observe` flag:

    ptt.flags.set_flag("observe", True)    # or PADDLE_TPU_OBSERVE=1

With the flag off, the prepared-program fast path performs ZERO registry
writes per step (one flag read + branch only). Plan-build events are
recorded regardless — they are never hot.
"""

from __future__ import annotations

from .. import flags as _flags
from . import flight, health, memory, metrics, pulse  # noqa: F401
from . import scrape, steplog, stitch, tracer, xray  # noqa: F401
from .flight import get_flight  # noqa: F401
from .health import get_engine  # noqa: F401
from .metrics import counter, default_registry, gauge, histogram  # noqa: F401
from .pulse import start_pulse, stop_pulse  # noqa: F401
from .scrape import Scraper, TimeSeriesStore  # noqa: F401
from .steplog import (StepStats, get_steplog, observatory,  # noqa: F401
                      preseed_shapes, track_shapes)
from .stitch import stitch_traces, trace_tree  # noqa: F401
from .tracer import get_tracer, merge_chrome_traces  # noqa: F401

# every flight-recorder dump carries the memory observatory
# (an OOM/SIGTERM death must be attributable to who held the bytes)
get_flight().add_section("memory", memory.get_observatory().flight_section)


def enabled() -> bool:
    """The hot-path gate: one flag-registry read."""
    return _flags.get_flag("observe")


def enable():
    _flags.set_flag("observe", True)


def disable():
    _flags.set_flag("observe", False)


def summary() -> dict:
    """One dict with everything a run left behind. Derived from
    pulse.status_document() (the live `/status` body) minus process
    identity, so the dead- and live-process shapes CANNOT diverge —
    one source of truth for the one-tool-reads-both contract."""
    doc = pulse.status_document()
    for k in ("pid", "process", "ts"):
        doc.pop(k, None)
    return doc


def reset():
    """Clear every telemetry store (tests / between measured segments)."""
    default_registry().reset()
    get_tracer().clear()
    get_steplog().clear()
    observatory().clear()


def reset_all():
    """`reset()` plus the fluid-xray stores (flight-recorder ring +
    stage, this thread's ambient trace context) and the fluid-pulse
    plane (the HTTP server thread is STOPPED, the health engine and
    memory observatory cleared). The tier-1 autouse fixture calls this
    so tests stop sharing process-global telemetry state — and can
    never leak a pulse thread."""
    reset()
    get_flight().clear()
    xray.reset()
    pulse.stop_pulse()
    health.reset()
    memory.reset()

"""Observability: the process-wide metrics registry, the span ring and
the W3C span contexts the serving path records under.

- `observe.metrics` — counters / gauges / histograms (thread-safe,
  labeled, snapshot/JSON/Prometheus export);
- `observe.tracer`  — spans in a bounded ring buffer;
- `observe.xray`    — trace contexts (trace id, span id, parent).

Span emission is gated on the `observe` flag (``flags.py``, or
``PADDLE_TPU_OBSERVE=1``): with it off the request path allocates no span
context and records nothing.
"""

from . import metrics, tracer as _tracer_module, xray  # noqa: F401
from .xray import (child_of, record_span, set_current,  # noqa: F401
                   tracer, unset_current)

get_tracer = _tracer_module.get_tracer


def reset():
    """Clear the metrics registry and the span ring (tests)."""
    metrics.default_registry().reset()
    get_tracer().clear()

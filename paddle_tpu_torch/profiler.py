"""Profiler (reference: python/paddle/fluid/profiler.py + platform/profiler.cc).

Mirror of ``paddle_tpu/profiler.py``. The JAX package captures device
timelines with `jax.profiler`; here `torch.profiler` does: `profiler` /
`start_profiler` record host operators, and under ``state="GPU"`` or
``"All"`` (with a card) the CUDA kernels through CUPTI, and write a
chrome://tracing file into `profile_path`. ``state="GPU"`` without a card
raises; ``"All"`` then records the host alone. The JAX package's state
name ``"TPU"`` is taken as ``"GPU"``, with a DeprecationWarning.

`record_event` / `print_host_events` / `export_chrome_tracing` work over
the `observe.tracer` ring buffer, as in the JAX package: a `record_event`
span also shows in a torch.profiler trace as a `record_function` range.
`cuda_profiler` marks its body as an NVTX range (`torch.cuda.nvtx`), so
that an external CUDA profiler sees it; the JAX package's is a no-op.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
import warnings

import torch

from .observe.tracer import get_tracer as _host_tracer

_STATES = ("CPU", "GPU", "All")
_DEPRECATED_STATES = ("TPU",)

_active = None   # the torch.profiler session of start_profiler


def _check_state(state: str) -> str:
    if state in _DEPRECATED_STATES:
        warnings.warn(
            f"profiler state {state!r} is the JAX package's name; on the "
            f"CUDA build use 'GPU' (or 'All')", DeprecationWarning,
            stacklevel=3)
        return "GPU"
    if state not in _STATES:
        raise ValueError(f"state must be CPU / GPU / All (got {state!r})")
    return state


def _activities(state: str):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if state == "GPU" and not torch.cuda.is_available():
        raise RuntimeError("profiler state 'GPU' needs a CUDA card "
                           "(torch.cuda.is_available() is False); pass "
                           "state='CPU'")
    if state in ("GPU", "All") and torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _default_path() -> str:
    return os.path.join(tempfile.gettempdir(), "profile")


def _open(state, profile_path):
    state = _check_state(state)
    os.makedirs(profile_path, exist_ok=True)
    prof = torch.profiler.profile(activities=_activities(state))
    prof.start()
    return prof


def _close(prof, profile_path) -> str:
    prof.stop()
    path = os.path.join(profile_path, "trace.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def profiler(state="All", sorted_key=None, profile_path=None):
    """reference profiler.py:profiler — a torch.profiler session around
    the body; yields the `torch.profiler.profile` (its `key_averages()`
    and `events()` are torch's) and writes ``trace.json`` into
    `profile_path`."""
    profile_path = profile_path or _default_path()
    prof = _open(state, profile_path)
    t0 = time.time()
    try:
        yield prof
    finally:
        path = _close(prof, profile_path)
        print(f"[paddle_tpu_torch.profiler] trace written to {path} "
              f"(wall {time.time() - t0:.3f}s); view with chrome://tracing "
              f"or perfetto")


@contextlib.contextmanager
def record_event(name: str):
    """reference platform::RecordEvent analog: a `record_function` range
    in a torch.profiler trace, and a span in the bounded host-event ring
    (print_host_events, export_chrome_tracing). Recorded even when the
    body raises — the failing iteration is usually the one being
    profiled."""
    with torch.profiler.record_function(name):
        with _host_tracer().span(name, cat="host"):
            yield


def start_profiler(state="All", profile_path=None):
    global _active
    if _active is not None:
        raise RuntimeError("start_profiler: a profiler is already running")
    _active = _open(state, profile_path or _default_path())


def stop_profiler(sorted_key=None, profile_path=None):
    """Stop `start_profiler`'s session; returns the trace file's path."""
    global _active
    if _active is None:
        raise RuntimeError("stop_profiler: no profiler is running")
    prof, _active = _active, None
    return _close(prof, profile_path or _default_path())


def reset_profiler():
    """Clear the host-event ring (reference ResetProfiler)."""
    _host_tracer().clear()


@contextlib.contextmanager
def cuda_profiler(output_file=None, output_mode=None, config=None):
    """The body as one NVTX range, named `output_file` (or
    "cuda_profiler"), for an external CUDA profiler to capture."""
    torch.cuda.nvtx.range_push(output_file or "cuda_profiler")
    try:
        yield
    finally:
        torch.cuda.nvtx.range_pop()


def print_host_events(sorted_key="total"):
    """Aggregated host-event table (reference DisableProfiler's printed
    table, profiler.cc:448)."""
    agg = _host_tracer().aggregate(cat="host")
    keyfn = {"total": lambda kv: -kv[1][1], "calls": lambda kv: -kv[1][0],
             "max": lambda kv: -kv[1][2], "min": lambda kv: kv[1][3],
             "ave": lambda kv: -kv[1][1] / kv[1][0]}.get(
        sorted_key, lambda kv: -kv[1][1])
    rows = sorted(agg.items(), key=keyfn)
    print(f"{'Event':<40} {'Calls':>8} {'Total(s)':>12} {'Avg(ms)':>10} "
          f"{'Max(ms)':>10} {'Min(ms)':>10}")
    for name, (calls, total, mx, mn) in rows:
        print(f"{name:<40} {calls:>8} {total:>12.4f} "
              f"{1000 * total / calls:>10.3f} {1000 * mx:>10.3f} "
              f"{1000 * mn:>10.3f}")
    return rows


def export_chrome_tracing(path: str):
    """Write the recorded host events as chrome://tracing JSON (reference
    tools/timeline.py:21); device timelines are in the trace `profiler`
    writes."""
    return _host_tracer().export_chrome(path)

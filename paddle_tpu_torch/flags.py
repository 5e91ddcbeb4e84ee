"""Runtime flag registry (reference: gflags end-to-end — FLAGS_check_nan_inf
/ FLAGS_benchmark etc. in C++, forwarded from `FLAGS_*` environment
variables at import by python/paddle/fluid/__init__.py). Copy of
``paddle_tpu/flags.py`` without its XLA-only flags.

Flags initialize from `PADDLE_TPU_<NAME>` (or legacy `FLAGS_<name>`)
environment variables and can be flipped at runtime with `set_flag`:
the executor reads the registry on every run, so a flip takes effect on
the next `run` call."""

from __future__ import annotations

import os
from typing import Any, Dict

_DEFS: Dict[str, tuple] = {
    # name: (default, type)
    "check_nan_inf": (False, bool),   # reference FLAGS_check_nan_inf
    # dropout lowering: "auto"/"xla" = the counter-hash bits path of
    # ops/nn.py (the default); "pallas" (the JAX package's name for its
    # hand-written kernel, kept so one setting means the same in both
    # packages) forces the hand-written kernel of ops/dropout_kernel.py on
    # eligible tensors for A/B measurement
    "dropout_impl": ("auto", str),
    # runtime telemetry (observe/): the serving path's span recording.
    # Off (default) keeps the request path free of span allocation
    "observe": (False, bool),
    # the distributed-tracing half of the observe plane (observe/xray):
    # span ids and span recording. Only consulted while "observe" is on
    "trace": (True, bool),
}

_FLAGS: Dict[str, Any] = {}

# bumped on every set_flag: hot paths memoize a flag read on this, so a
# per-request "did a flag change?" check is one int compare (a flip still
# takes effect on the next call)
_VERSION = 0


def version() -> int:
    return _VERSION


def _coerce(val: str, typ):
    if typ is bool:
        return val.lower() in ("1", "true", "yes", "on")
    return typ(val)


def _init():
    for name, (default, typ) in _DEFS.items():
        env = os.environ.get(f"PADDLE_TPU_{name.upper()}",
                             os.environ.get(f"FLAGS_{name}"))
        val = _coerce(env, typ) if env is not None else default
        if name in _CHOICES and env is not None:
            val = str(val).lower()
            if val not in _CHOICES[name]:
                raise ValueError(f"flag {name!r} must be one of "
                                 f"{_CHOICES[name]}, got {val!r}")
        _FLAGS[name] = val


def get_flag(name: str):
    if name not in _FLAGS:
        raise KeyError(f"unknown flag {name!r}; known: {sorted(_FLAGS)}")
    return _FLAGS[name]


# enumerated string flags: value must be one of the choices (a typo like
# dropout_impl=palas would otherwise silently select the default path)
_CHOICES: Dict[str, tuple] = {
    "dropout_impl": ("auto", "pallas", "xla"),
}


def set_flag(name: str, value):
    global _VERSION
    if name not in _FLAGS:
        raise KeyError(f"unknown flag {name!r}; known: {sorted(_FLAGS)}")
    if name in _CHOICES:
        value = str(value).lower()
        if value not in _CHOICES[name]:
            raise ValueError(
                f"flag {name!r} must be one of {_CHOICES[name]}, got {value!r}")
    _FLAGS[name] = value
    _VERSION += 1


def all_flags() -> Dict[str, Any]:
    return dict(_FLAGS)


_init()

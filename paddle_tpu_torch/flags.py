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
}

_FLAGS: Dict[str, Any] = {}


def _coerce(val: str, typ):
    if typ is bool:
        return val.lower() in ("1", "true", "yes", "on")
    return typ(val)


def _init():
    for name, (default, typ) in _DEFS.items():
        env = os.environ.get(f"PADDLE_TPU_{name.upper()}",
                             os.environ.get(f"FLAGS_{name}"))
        _FLAGS[name] = _coerce(env, typ) if env is not None else default


def get_flag(name: str):
    if name not in _FLAGS:
        raise KeyError(f"unknown flag {name!r}; known: {sorted(_FLAGS)}")
    return _FLAGS[name]


def set_flag(name: str, value):
    if name not in _FLAGS:
        raise KeyError(f"unknown flag {name!r}; known: {sorted(_FLAGS)}")
    _FLAGS[name] = value


def all_flags() -> Dict[str, Any]:
    return dict(_FLAGS)


_init()

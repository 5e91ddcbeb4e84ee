"""Thread-local default-scope stack (a copy of
``paddle_tpu/default_scope_funcs.py``; reference:
python/paddle/fluid/default_scope_funcs.py). The reference kept a stack of
C++ scopes for SWIG-era code; here the stack holds core Scope objects over
the same global root used by the Executor."""

from __future__ import annotations

import threading

from .core.executor import Scope, global_scope

__all__ = [
    "get_cur_scope",
    "enter_local_scope",
    "leave_local_scope",
    "var",
    "find_var",
    "scoped_function",
]

_tls = threading.local()


def _stack():
    if not hasattr(_tls, "stack") or not _tls.stack:
        _tls.stack = [global_scope()]
    return _tls.stack


def get_cur_scope() -> Scope:
    """Innermost scope (reference default_scope_funcs.py get_cur_scope)."""
    return _stack()[-1]


def enter_local_scope():
    cur = get_cur_scope()
    _stack().append(cur.new_scope())


def leave_local_scope():
    _stack().pop()
    get_cur_scope().drop_kids()


def var(name: str):
    """Get-or-create a variable slot in the current scope (the reference's
    Scope::Var). Creates an uninitialized (None) entry when absent."""
    scope = get_cur_scope()
    if scope.var(name) is None and not scope.has_var(name):
        scope.set_var(name, None)
    return scope.var(name)


def find_var(name: str):
    return get_cur_scope().find_var(name)


def scoped_function(func):
    """Run `func` inside a fresh local scope (reference scoped_function)."""
    enter_local_scope()
    try:
        return func()
    finally:
        leave_local_scope()

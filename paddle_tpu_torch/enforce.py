"""Structured runtime checks (a copy of ``paddle_tpu/enforce.py``).

Capability parity with the reference's enforce layer (reference:
paddle/fluid/platform/enforce.h — PADDLE_ENFORCE* :232-272 and the
`EnforceNotMet` exception :66 that carries a captured stack). Graph-build
and host-side runtime code raise `EnforceNotMet` with the failing
condition, a formatted message and the offending frame, so user errors
surface at the API boundary instead of deep inside an op rule.
"""

from __future__ import annotations

import traceback


class EnforceNotMet(RuntimeError):
    """reference EnforceNotMet (enforce.h:66): message + capture site."""

    def __init__(self, message: str):
        # innermost frame OUTSIDE this module = the enforcement site
        frame = None
        for f in reversed(traceback.extract_stack()):
            if f.filename != __file__:
                frame = f
                break
        where = (f"\n  [enforced at {frame.filename}:{frame.lineno} "
                 f"in {frame.name}]") if frame else ""
        super().__init__(message + where)


def enforce(cond, msg="enforce failed", *fmt_args):
    if not cond:
        raise EnforceNotMet(msg % fmt_args if fmt_args else msg)


def enforce_eq(a, b, msg=None):
    if a != b:
        raise EnforceNotMet(msg or f"enforce_eq failed: {a!r} != {b!r}")


def enforce_ne(a, b, msg=None):
    if a == b:
        raise EnforceNotMet(msg or f"enforce_ne failed: both {a!r}")


def enforce_gt(a, b, msg=None):
    if not a > b:
        raise EnforceNotMet(msg or f"enforce_gt failed: {a!r} <= {b!r}")


def enforce_ge(a, b, msg=None):
    if not a >= b:
        raise EnforceNotMet(msg or f"enforce_ge failed: {a!r} < {b!r}")


def enforce_lt(a, b, msg=None):
    if not a < b:
        raise EnforceNotMet(msg or f"enforce_lt failed: {a!r} >= {b!r}")


def enforce_le(a, b, msg=None):
    if not a <= b:
        raise EnforceNotMet(msg or f"enforce_le failed: {a!r} > {b!r}")


def enforce_not_none(v, msg=None):
    if v is None:
        raise EnforceNotMet(msg or "enforce_not_none failed")
    return v


def enforce_shape_match(shape, expected, msg=None):
    """Dims match where expected is not -1 (dynamic)."""
    shape, expected = tuple(shape), tuple(expected)
    ok = len(shape) == len(expected) and all(
        e == -1 or s == e or s == -1 for s, e in zip(shape, expected))
    if not ok:
        raise EnforceNotMet(msg or f"shape mismatch: got {shape}, "
                                   f"expected {expected}")

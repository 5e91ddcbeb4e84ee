"""Unique name generator (reference: python/paddle/fluid/unique_name.py)."""

from __future__ import annotations

import contextlib
from collections import defaultdict


class UniqueNameGenerator:
    def __init__(self):
        self.ids = defaultdict(int)

    def __call__(self, prefix: str) -> str:
        i = self.ids[prefix]
        self.ids[prefix] += 1
        return f"{prefix}_{i}"


_generator = UniqueNameGenerator()


def generate(prefix: str) -> str:
    return _generator(prefix)


@contextlib.contextmanager
def guard(new_generator=None):
    """Scope the counter (reference unique_name.guard) so separate programs
    can reuse parameter names deterministically."""
    global _generator
    prev = _generator
    _generator = new_generator or UniqueNameGenerator()
    try:
        yield
    finally:
        _generator = prev


def switch(new_generator=None):
    """Swap the global generator, returning the old one (reference
    unique_name.switch — guard() is built on it there)."""
    global _generator
    prev = _generator
    _generator = new_generator or UniqueNameGenerator()
    return prev

"""Models of the slice."""

from . import tiny_lm  # noqa: F401

"""Observability: the process-wide metrics registry."""

from . import metrics  # noqa: F401

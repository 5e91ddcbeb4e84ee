"""Models of the slices: tiny_lm (serving) and the Transformer (training)."""

from . import tiny_lm, transformer  # noqa: F401

"""Reader composition toolkit (reference: python/paddle/reader/); mirror
of ``paddle_tpu/reader``."""

from .decorator import (map_readers, shuffle, chain, compose, buffered,  # noqa: F401
                        firstn, xmap_readers, cache, batch,
                        ComposeNotAligned, PipeReader)
from .py_reader import PyReader, py_reader  # noqa: F401
from . import creator  # noqa: F401

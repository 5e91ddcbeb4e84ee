"""`fluid.contrib.decoder` (reference contrib/decoder/__init__.py)."""

from . import beam_search_decoder  # noqa: F401
from .beam_search_decoder import (InitState, StateCell, TrainingDecoder,  # noqa: F401
                                  BeamSearchDecoder)

__all__ = ["beam_search_decoder", "InitState", "StateCell",
           "TrainingDecoder", "BeamSearchDecoder"]

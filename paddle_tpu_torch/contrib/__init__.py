"""`fluid.contrib` namespace (mirror of ``paddle_tpu/contrib``;
reference python/paddle/fluid/contrib/)."""

from . import decoder  # noqa: F401
from .decoder import InitState, StateCell, TrainingDecoder, BeamSearchDecoder  # noqa: F401

__all__ = ["decoder", "InitState", "StateCell", "TrainingDecoder",
           "BeamSearchDecoder"]

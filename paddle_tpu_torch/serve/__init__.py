"""Generative serving: registry, paged KV cache, decode engine, server.

Mirror of ``paddle_tpu/serve`` for generative models (the one-shot
MicroBatcher path, hot swap and disaggregated serving are not ported
yet)."""

from __future__ import annotations

from .batcher import SlotScheduler  # noqa: F401
from .bucketing import BucketLadder, warm_feed_shapes  # noqa: F401
from .decode import (DecodeEngine, GenerationResult,  # noqa: F401
                     GenerationStream)
from .errors import (BadRequestError, CacheExhaustedError,  # noqa: F401
                     DeadlineExceededError, ModelNotFoundError,
                     ModelUnavailableError, QueueFullError, ServeError)
from .kvcache import (PagedKVCache, block_residency_nbytes,  # noqa: F401
                      blocks_for_budget)
from .registry import ModelRegistry, ModelVersion  # noqa: F401
from .server import InferenceServer, ServeConfig  # noqa: F401

"""Serving: registry, bucketing, batching, paged KV cache, decode engine.

Mirror of ``paddle_tpu/serve``:

- `serve.registry` — ModelRegistry: loads `save_inference_model` dirs
  (sha256-verified against their MANIFEST.json) into warmed prepared
  programs, hot-swaps new versions behind an atomic pointer, retires old
  ones after in-flight requests drain;
- `serve.bucketing` — BucketLadder + planner: pads every request onto a
  ladder of shapes the registry ran once at load;
- `serve.batcher` — MicroBatcher: per-bucket queues coalescing
  concurrent one-shot requests up to the top rung or `batch_timeout_ms`,
  bounded admission (QueueFullError fast-reject) and per-request
  deadlines; SlotScheduler: the generative engine's slots;
- `serve.decode` — DecodeEngine: prefill + fixed-slot decode steps with
  continuous batching over the paged KV cache (`serve.kvcache`).

`serve.InferenceServer` fronts them. Its `submit_prefill` /
`submit_prefilled` are the two halves of a disaggregated generation
(``torrent/`` streams the KV rows between them; ``fleet/`` routes).
"""

from __future__ import annotations

from .batcher import MicroBatcher, SlotScheduler  # noqa: F401
from .bucketing import (DEFAULT_ROWS_LADDER, BucketLadder,  # noqa: F401
                        load_trace, plan_request, predicted_padding_waste,
                        save_trace, trace_request, warm_feed_shapes)
from .decode import (DecodeEngine, GenerationResult,  # noqa: F401
                     GenerationStream)
from .errors import (BadRequestError, CacheExhaustedError,  # noqa: F401
                     DeadlineExceededError, KVTransferError,
                     ModelNotFoundError, ModelUnavailableError,
                     QueueFullError, ServeError)
from .kvcache import (PagedKVCache, block_residency_nbytes,  # noqa: F401
                      blocks_for_budget)
from .registry import (DecodeModel, ModelRegistry,  # noqa: F401
                       ModelVersion, read_decode_signature,
                       read_model_manifest)
from .server import InferenceServer, ServeConfig  # noqa: F401

"""fluid-ark: fault-tolerant training (mirror of ``paddle_tpu/ark``).

Four layers, each copied from the JAX package (reference analogs in each
module's docstring):

- `checkpoint` — atomic, manifest-verified, rotated checkpoints
  (reference `CheckpointConfig`/`save_checkpoint` + checkpoint-notify,
  crash-hardened: tmp-dir + rename commit, sha256 MANIFEST, RNG cursors;
  `Trainer.train(checkpoint=ark.CheckpointConfig(...))`);
- `retry` — bounded exponential backoff with jitter for `PSClient` RPCs
  (reference gRPC client retry);
- `liveness` — heartbeat leases + the evicting sync barrier so a dead
  trainer degrades the world to N-1 instead of wedging it;
- `heartbeat` — the trainer-side lease renewal thread;
- `chaos` — the seed-deterministic fault injector that proves all of the
  above actually recovers (`tools/torch_chaos_drill.py` drives it).
"""

from .checkpoint import (CheckpointConfig, CheckpointError,  # noqa: F401
                         atomic_file, file_sha256, latest_checkpoint,
                         list_checkpoints, load_checkpoint, read_manifest,
                         save_checkpoint, verify_checkpoint,
                         verify_sidecar, write_sidecar_manifest)
from .retry import NO_RETRY, RetryPolicy  # noqa: F401
from .liveness import (EvictingBarrier, LeaseTable,  # noqa: F401
                       QuorumLeaseTable)
from .heartbeat import HeartbeatThread  # noqa: F401
from . import chaos  # noqa: F401

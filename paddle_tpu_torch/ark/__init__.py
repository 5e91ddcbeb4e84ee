"""fluid-ark's durable checkpoints (mirror of ``paddle_tpu/ark``).

Only `checkpoint` is ported: atomic, manifest-verified, rotated
checkpoints with the training cursor and the executor's run counts
(`Trainer.train(checkpoint=ark.CheckpointConfig(...))`). The JAX
package's `retry`, `liveness`, `heartbeat` and `chaos` serve its
parameter-server and elastic planes, which the port does not have yet
(ROADMAP Queue 1 item 8).
"""

from .checkpoint import (CheckpointConfig, CheckpointError,  # noqa: F401
                         atomic_file, file_sha256, latest_checkpoint,
                         list_checkpoints, load_checkpoint, read_manifest,
                         save_checkpoint, verify_checkpoint,
                         verify_sidecar, write_sidecar_manifest)

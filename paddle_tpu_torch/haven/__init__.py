"""fluid-haven: a replicated, self-healing parameter-server plane.

Mirror of ``paddle_tpu/haven/``, copied (host services in numpy).

`ark/` gave pserver training checkpoints, retries, and READ
failover; a pserver death still lost every update since the last
checkpoint serial and wedged training until an operator restarted it.
fluid-haven makes a shard survivable in lease-time with a provable loss
bound — the TF system paper's PS fault-tolerance story, and the layer
the reference repo's etcd-backed Go EDL pserver occupied in the cloud
deployment:

- **write-path replication** (`replication.py`): the primary forwards
  every applied update to a backup as logical update records over the
  existing rpc framing (the trainer's codec-tagged fluid-wire payloads
  travel verbatim, so the backup is bit-identical and the replication
  hop is as compressed as the trainer hop);
- **bounded-async update log** (`log.py`): sequence-numbered records
  with an acknowledged watermark; failover loss is provably <= the
  in-flight window because `append` backpressures when it fills;
- **lease-based failover**: the backup holds the primary's heartbeat
  lease (`ark.LeaseTable`) and promotes itself when it expires, fenced
  by a monotone epoch; `PSClient` re-resolves a shard's primary on
  transport error or redirect and replays un-watermarked pushes through
  the existing dedup, so promotion never double-applies;
- **live shard handoff**: `ParameterServer.handover()` streams a
  consistent snapshot + log tail to a fresh process, flips the lease
  with zero failed trainer pushes, and retires.

See docs/FAULT_TOLERANCE.md §Replicated PS plane for the contract, the
loss-bound pin, and how to read the `ps_replication_*` metrics.
"""

from .log import ReplicationStalled, UpdateLog  # noqa: F401
from .replication import (CONTROL_CMDS, COUNTED_CMDS,  # noqa: F401
                          DISPATCH_RECORDED_CMDS, LAG_UPDATES_METRIC,
                          LAG_US_METRIC, MUTATING_CMDS, PROMOTIONS_METRIC,
                          READ_CMDS, RECORDED_CMDS, STEP_DOWNS_METRIC,
                          SYNC_APPLY_RECORD, SYNC_RESET_RECORD, HavenState,
                          Replicator)

"""fluid-quorum: a partition-safe coordination plane.

Mirror of ``paddle_tpu/quorum/``, copied (host services: sockets,
threads and json; no tensor crosses its wire).

fluid-haven documented its own limit: a 2-node
primary/backup pair cannot tell "peer died" from "peer unreachable",
so lease-expiry auto-promotion had to stay off on partition-risky
networks — availability traded for safety. The reference repo parked
exactly this problem on etcd (its Go EDL master/pserver lean on etcd
leases for election and liveness); the TF system paper makes the same
move. fluid-quorum is that layer: a small
majority-lease arbiter riding the existing pserver RPC framing.

- **`QuorumNode`** (`node.py`): one arbiter process/thread holding
  per-resource lease records and a PERSISTED monotone fencing epoch
  (ark atomic-checkpoint idiom: tmp + `os.replace` + sha256 sidecar),
  so an arbiter restart can never regress an epoch it promised. A
  freshly restarted node also refuses new campaigns until any lease it
  might have granted before the crash has provably expired (the boot
  blackout) — losing the volatile lease table cannot mint two holders.

- **`QuorumClient`** (`client.py`): `campaign(resource)` / `renew` /
  `resign` against a 3- or 5-node arbiter group. A lease is HELD only
  with acks from a strict majority of nodes, every grant carries the
  fencing epoch (strictly above every epoch any majority ever granted),
  and a renew that cannot reach a majority FAILS CLOSED — the holder
  must stop accepting writes before the arbiters' lease expiry lets a
  rival win.

- **haven integration** (`haven/replication.py`): with a quorum
  configured, the standby promotes only on a quorum-granted lease and
  the primary self-fences when it cannot renew — `auto_promote=True`
  becomes the safe default under asymmetric partitions, and a deposed
  primary that still holds trainer sockets is fenced by epoch.

- **membership backing** (`ark/liveness.py::QuorumLeaseTable`,
  `ark/heartbeat.py`): an opt-in second liveness opinion for lease
  tables (fleet routers, pserver trainer leases) — a member that lost
  its path to the table owner but still renews at the arbiters is not
  falsely evicted. Without a quorum configured, every lease table
  behaves exactly as before.

See docs/FAULT_TOLERANCE.md §Quorum arbiter for the protocol, the
failure-model upgrade (crash-stop -> partition-tolerant), and the
3-vs-5-node sizing guidance; `ark/chaos.py::NetPartition` +
`tools/torch_chaos_drill.py --scenario ps_partition` prove the claims.
"""

from .client import (EPOCH_METRIC, GRANTS_METRIC,  # noqa: F401
                     LEASE_OK_METRIC, MAJORITY_METRIC, UNREACHABLE_METRIC,
                     QuorumClient, QuorumLease, QuorumUnavailable)
from .node import QuorumNode, QuorumStore  # noqa: F401

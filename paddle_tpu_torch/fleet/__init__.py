"""fluid-fleet: the multi-replica serving tier (see docs/FLEET.md).

Mirror of ``paddle_tpu/fleet/__init__.py``, copied.

`InferenceServer` scales one process; the north star's "heavy traffic
from millions of users" needs a FLEET. Four pieces, each reusing a
subsystem the repo already trusts:

- `fleet.router`  — FleetRouter: ark-lease membership, pulse-/readyz-
  gated readiness ("right version, warmed"), least-loaded dispatch,
  retry/failover with retriable-vs-terminal classification, and the
  two-phase version-skew-free coordinated hot swap;
- `fleet.replica` — ReplicaServer: the TCP RPC front of one
  InferenceServer (requests tagged with the executing version, swap
  prepare/commit/abort, readyz, per-process observatory stats) plus the
  membership heartbeat;
- `fleet.sparse`  — the serve-time distributed embedding read path:
  models whose lookup tables live only in pserver shards
  (`save_sparse_inference_model`) pull rows at inference through a
  read-only wire-codec PSClient and a bounded, version-keyed row cache;
- `fleet.wire`    — the pooled framed transport both sides ride.

Drills: `tools/torch_serve_loadgen.py --replicas N` (QPS scaling +
skew-free swap under load), `tools/torch_chaos_drill.py --scenario
replica_kill` (a SIGKILLed replica degrades p99, not availability).
"""

from __future__ import annotations

from .replica import ReplicaServer  # noqa: F401
from .router import (FleetError, FleetResult, FleetRouter,  # noqa: F401
                     RouterConfig)
from .sparse import (DEFAULT_CACHE_ROWS, RowCache,  # noqa: F401
                     SparseLookupPlan, SparseServeConfig,
                     save_sparse_inference_model, sparse_table_specs)
from .wire import ConnPool  # noqa: F401

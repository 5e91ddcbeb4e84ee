"""Elastic data-sharding master (reference: go/master/ — task queue with
lease timeouts, failure budgets, and snapshot/recover; the P9 elastic
training capability; mirror of ``paddle_tpu/master/``). fluid-elastic:
HA pairs behind the quorum arbiter (`Master.start_replication` /
`start_standby`) with exactly-once task accounting across failover."""

from .service import DatasetMismatchError, Master  # noqa: F401
from .client import MasterClient  # noqa: F401

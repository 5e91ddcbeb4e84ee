"""Host parameter-server runtime: async (barrierless) and sync
(per-batch barrier) updates + distributed sparse lookup tables
(reference: listen_and_serv_op.cc RunSyncLoop :106 / RunAsyncLoop :195,
doc/fluid/design/dist_train/distributed_lookup_table_design.md).

Mirror of ``paddle_tpu/pserver/``: the servers, the wire, the client and
the numpy optimizers are copied (numpy only: a server never imports a
card); the trainers drive the port's `Executor`, whose step runs on the
card while the parameter exchange crosses the host. The sync default of
`DistributeTranspiler` remains the collective runtime (the SPMD
interpreter's all-reduce); `config.runtime = "pserver"` plans this one."""

from .server import ParameterServer  # noqa: F401
from .client import PSClient  # noqa: F401
from .trainer import AsyncPSTrainer, SyncPSTrainer  # noqa: F401

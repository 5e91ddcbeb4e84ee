"""Parallel execution over meshes of ranks (torch.distributed).

Mirror of ``paddle_tpu/parallel/``. The JAX package compiles one Program
under a `jax.sharding.Mesh` and GSPMD inserts the collectives; here each
rank is a process that runs the Program on its own shards, and
``spmd.py`` inserts the collectives that keep the result the
single-device Program's (``parallel_executor.py`` drives it).
"""

from .parallel_executor import (BuildStrategy, ExecutionStrategy,  # noqa: F401
                                ParallelExecutor, collective_inventory)
from .mesh import (Mesh, auto_mesh, batch_sharded,  # noqa: F401
                   get_default_mesh, make_mesh, replicated)
